"""Share of its roofline that the ``gear`` kernel reached over the
window: the least time for the gear hash at every byte of every image
written (the ``gear`` work of the cell's chunking rule: 1 byte read and
4 written a byte, against its integer instructions), over the kernel's
time summed from the device trace."""


def read(run):
    return run.roofline_pct("gear_kernel", "gear")
