"""Hand-written Hopper kernels, each beside its plain torch version.

The counterparts of the JAX package's `pinot_tpu.ops` exports and of its
exact group-by:

| here | pinot_tpu.ops (groupby_pallas.py) | kernel source |
|---|---|---|
| `grouped_sum` | `pallas_grouped_sum` | `csrc/grouped_sum_f32.cu` |
| `grouped_count` | `pallas_grouped_count` | `csrc/grouped_sum_f32.cu` |
| `grouped_min` | `pallas_grouped_min` | `csrc/grouped_extreme.cu` |
| `grouped_max` | `pallas_grouped_max` | `csrc/grouped_extreme.cu` |
| `grouped_extremes` | every MIN / MAX of one group-by (the reference engine's `segment_min/max`) in one pass | `csrc/grouped_extreme.cu` |
| `presence` | `pallas_presence` (and the engine's grouped presence) | `csrc/grouped_sum_f32.cu` |
| `presences` | every DISTINCTCOUNT presence of a query in one pass | `csrc/grouped_sum_f32.cu` |
| `grouped_multi_sum` | `pallas_grouped_multi_sum_blocked` | `csrc/grouped_sum_count.cu` while the counters fit shared memory, else `csrc/grouped_sum_count_2l.cu` |
| `grouped_multi_sum_2l` | `pallas_grouped_multi_sum` under `PINOT_TPU_PALLAS_V2` (`_planes2_impl`) | `csrc/grouped_sum_count_2l.cu` |

A CUDA tensor launches the kernel, a CPU tensor takes the plain version.
"""

from pinot_tpu_torch.ops.extreme import grouped_extreme, grouped_extremes, grouped_max, grouped_min
from pinot_tpu_torch.ops.groupby import grouped_multi_sum, grouped_multi_sum_2l, grouped_multi_sum_plain
from pinot_tpu_torch.ops.grouped_sum_f32 import grouped_count, grouped_sum, presence, presences

__all__ = [
    "grouped_sum",
    "grouped_count",
    "grouped_min",
    "grouped_max",
    "presence",
    "presences",
    "grouped_extreme",
    "grouped_extremes",
    "grouped_multi_sum",
    "grouped_multi_sum_2l",
    "grouped_multi_sum_plain",
]
