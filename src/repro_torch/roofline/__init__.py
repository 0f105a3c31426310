"""Work counts and roofline terms of the port's programs (port of
`repro.roofline`): `op_stats` counts a torch program's flops and bytes as
`hlo_stats` reads them off HLO, `kernel_work` gives each hand-written
kernel's least work, `report` turns a record into the card's roofline
terms."""
from .op_stats import OpCounter, OpStats, attribution_summary, count
from .report import model_flops, roofline_from_record

__all__ = ["OpCounter", "OpStats", "attribution_summary", "count",
           "model_flops", "roofline_from_record"]
