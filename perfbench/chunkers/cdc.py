"""LBFS's content-defined rule (``reference.py``): word ``a`` of the MD5
of the ``window`` bytes at every ``stride``-th offset, a chunk ending
after each window whose hash has its low ``log2(avg_chunk)`` bits zero,
``min_chunk`` and ``max_chunk`` enforced greedily from the start."""
import torch

from perfbench import reference, roofline


def bounds(image, sai, device):
    """Chunk end offsets of ``image`` (uint8 array); the window hashes
    are computed on ``device``."""
    data = torch.from_numpy(image).to(device)
    cands = reference.chunk_candidates(data, sai["window"], sai["stride"],
                                       sai["avg_chunk"])
    return reference.cdc_boundaries(cands, image.size, sai["min_chunk"],
                                    sai["max_chunk"])


def work(length, sai):
    """Device work of chunking one image of ``length`` bytes, as
    (integer instructions, bytes): ``sliding_md5``'s window hashes, and
    the rule's test over them (``candidates``: each 4-byte hash read
    once).  The candidates' 8-byte offsets that the test writes are left
    out: the length does not give their count, and at one candidate in
    ``avg_chunk`` windows they are 2 / ``avg_chunk`` of the bytes read
    (0.02% at 8 KiB).  No instruction is counted for the test; its bytes
    bound it."""
    window, stride = sai["window"], sai["stride"]
    n = reference.n_windows(length, window, stride)
    return {"sliding_md5": roofline.sliding_work(length, window, stride),
            "candidates": (0.0, 4.0 * n)}
