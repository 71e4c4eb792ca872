"""Share of its roofline that ``md5_direct`` reached over the window: the
least time for every block digest the window's operations asked for,
over the kernel's time summed from the device trace."""


def read(run):
    return run.roofline_pct("md5_direct_kernel", "md5_direct")
