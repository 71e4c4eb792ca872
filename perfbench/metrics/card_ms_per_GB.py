"""Milliseconds the card was busy (any kernel, copy or set, from the
device trace) per GB (1e9 bytes) the window's operations moved: the card
time the storage path takes from the application that shares the card,
over the window less its pauses.  None where the trace holds no device
operation (no card)."""


def read(run):
    if run.device is None or run.bytes_done <= 0:
        return None
    busy = run.device.busy_s
    if busy <= 0:
        return None
    return 1e3 * busy / (run.bytes_done / 1e9)
