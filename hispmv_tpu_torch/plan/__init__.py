from hispmv_tpu_torch.plan.partition import StreamPlan, build_plan  # noqa: F401
from hispmv_tpu_torch.plan.blocks import BlockPlan, build_block_plan  # noqa: F401
from hispmv_tpu_torch.plan.windows import WindowPlan, build_window_plan  # noqa: F401


def __getattr__(name):
    # serialize imports every plan type, and the ELLX plan lives in ops,
    # which imports this package: load it at first use
    if name in ("save_plan", "load_plan"):
        from hispmv_tpu_torch.plan import serialize

        return getattr(serialize, name)
    raise AttributeError(name)
