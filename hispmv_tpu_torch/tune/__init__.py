"""The cost-model tuner: per-matrix design-space exploration over the
formats and block heights, ranked by an analytic cost model under a device
profile (``tune`` takes its device's: ``H100`` on the card, ``V5E`` on the
CPU), optionally refined by timing the shortlist on the handle's
device."""

from hispmv_tpu_torch.tune.cost import CostModel, DeviceProfile  # noqa: F401
from hispmv_tpu_torch.tune.dse import DSE, TuneResult, tune  # noqa: F401
