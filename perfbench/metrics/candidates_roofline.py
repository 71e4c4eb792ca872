"""Share of its roofline that the boundary-candidate compaction reached
over the window: the least time for the rule's test over every window
hash of every image written (the ``candidates`` work of the cell's
chunking rule), over the time of its count and scatter passes
(``candidate_count_kernel``, ``candidate_scatter_kernel``) summed from
the device trace."""


def read(run):
    return run.roofline_pct("candidate_", "candidates")
