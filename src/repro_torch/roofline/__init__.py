from repro_torch.roofline.analysis import (  # noqa: F401
    HW, hash_cost_seed, roofline_terms)
