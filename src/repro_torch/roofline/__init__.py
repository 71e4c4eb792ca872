from repro_torch.roofline.analysis import (  # noqa: F401
    HW, hash_cost_seed, roofline_terms)
from repro_torch.roofline.hlo_analysis import (  # noqa: F401
    analyze_hlo, collective_bytes_from_hlo)
