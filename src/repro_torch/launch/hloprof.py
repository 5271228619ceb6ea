"""Byte breakdown by op of a traced step — the dry-run's 'profiler'
(``repro/launch/hloprof.py``).

With no wall clock for a production mesh, the per-op result bytes of one
rank's traced step (``launch.roofline.StepTrace``) are the profile: they
show where the memory term comes from (an S^2 attention
materialisation, say) and which collectives move the bytes. The
reference reads the same from the compiled HLO's text; here the ops are
recorded as they run.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from repro_torch.launch.roofline import StepTrace


def bytes_by_op(trace: StepTrace, top: int = 25) -> Dict[str, int]:
    """Result bytes summed per op name, the largest ``top``."""
    agg: Dict[str, int] = defaultdict(int)
    for op in trace.ops:
        agg[op.name] += op.result_bytes
    return dict(sorted(agg.items(), key=lambda kv: -kv[1])[:top])


def biggest_tensors(trace: StepTrace, top: int = 15
                    ) -> List[Tuple[int, str, str]]:
    """The largest single results: (bytes, op name, shapes)."""
    rows = [(op.result_bytes, op.name, str(op.shapes)[:80])
            for op in trace.ops]
    rows.sort(reverse=True)
    return rows[:top]
