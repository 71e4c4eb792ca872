"""Share of its roofline that ``sliding_md5`` reached over the window: the
least time for the window hashes of every image written, over the
kernel's time summed from the device trace."""


def read(run):
    return run.roofline_pct("sliding_md5_kernel", "sliding_md5")
