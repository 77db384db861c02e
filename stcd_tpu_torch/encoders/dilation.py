"""smp's ``make_dilated`` rate formula (counterpart of
stcd_tpu/encoders/dilation.py:16-21).

A stage-uniform encoder dilates every conv of a flagged stage at the
cumulative doubling that includes its own flag: output_stride 8 on a
3-flag encoder gives flags (False, True, True) and rates (1, 2, 4). The
ResNet family does not use it: it follows torchvision's per-block rule
(``encoders/resnet.py``), as the JAX package does.
"""

from typing import Sequence, Tuple


def make_dilated_rates(flags: Sequence[bool]) -> Tuple[int, ...]:
    """Per-flag dilation rates: ``rates[k] = 2 ** sum(flags[:k + 1])`` when
    ``flags[k]`` is set, else 1 (the stage keeps its stride)."""
    return tuple(2 ** sum(map(bool, flags[: k + 1])) if flags[k] else 1
                 for k in range(len(flags)))
