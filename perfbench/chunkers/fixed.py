"""The fixed-block rule: a chunk ends every ``block_size`` bytes and at
the image's end.  Splitting asks nothing of the card."""
from perfbench import reference


def bounds(image, sai, device):
    """Chunk end offsets of ``image`` (uint8 array)."""
    return reference.fixed_boundaries(image.size, sai["block_size"])


def work(length, sai):
    """Device work of chunking one image: none."""
    return {}
