"""The cost-model tuner: per-matrix design-space exploration over the
formats and block heights, ranked by an analytic cost model (the TPU v5e
profile by default), optionally refined by timing the shortlist on the
handle's device."""

from hispmv_tpu_torch.tune.cost import CostModel, DeviceProfile  # noqa: F401
from hispmv_tpu_torch.tune.dse import DSE, TuneResult, tune  # noqa: F401
