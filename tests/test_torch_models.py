"""The port's model layer against the JAX package's.

- ``SparseLinear`` draws its mask from an explicit ``torch.Generator``.
- ``load_flax_variables`` carries the flax ``ThreeLayerFCModel`` weights
  into the port's model; both then compute the same function (rtol=1e-5,
  atol=1e-5*max(1, max|y|): fp32 on both sides, summation order only).
- ``extract_linears`` gives the JAX package's arrays, array for array.
- ``AcceleratorLayerManager`` on a CPU ``Accelerator`` against the JAX
  ``AcceleratedModel`` (same tolerance) and against flax
  (``compare_model_outputs``, rtol=1e-3, atol=1e-4).
- The budget ``MemoryError`` and the demo CLI at small widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hispmv_tpu.models import AcceleratorLayerManager as JManager
from hispmv_tpu.models import ThreeLayerFCModel as JModel
from hispmv_tpu.models import extract_linears as jextract_linears
from hispmv_tpu_torch import Accelerator
from hispmv_tpu_torch.models import (
    AcceleratedModel,
    AcceleratorLayerManager,
    SparseLinear,
    ThreeLayerFCModel,
    compare_model_outputs,
    extract_linears,
    load_flax_variables,
)
from hispmv_tpu_torch.models import demo

IN, HIDDEN, OUT, DENSITY = 64, 96, 32, 0.2


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def flax_model(seed=2):
    model = JModel(hidden=HIDDEN, out=OUT, density=DENSITY)
    variables = model.init(jax.random.PRNGKey(seed), jnp.ones((1, IN)))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def carried(variables):
    """The port's model holding the flax weights."""
    model = ThreeLayerFCModel(IN, HIDDEN, OUT, DENSITY,
                              generator=torch.Generator().manual_seed(0))
    load_flax_variables(model, variables)
    return model


def inputs(n=4, seed=3):
    return np.random.default_rng(seed).standard_normal((n, IN)).astype(
        np.float32)


def test_sparse_linear_density_from_generator():
    m = SparseLinear(128, 256, density=0.1,
                     generator=torch.Generator().manual_seed(0))
    assert m.weight.shape == (256, 128) and m.mask.shape == (256, 128)
    assert 0.05 < float(m.mask.mean()) < 0.15
    assert set(torch.unique(m.mask).tolist()) <= {0.0, 1.0}
    again = SparseLinear(128, 256, density=0.1,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(m.mask, again.mask)
    assert torch.equal(m.weight, again.weight)
    other = SparseLinear(128, 256, density=0.1,
                         generator=torch.Generator().manual_seed(1))
    assert not torch.equal(m.mask, other.mask)
    # lecun_normal: variance 1/fan_in, folded into two standard deviations
    std = float(m.weight.detach().std())
    assert 0.7 / 128 ** 0.5 < std < 1.3 / 128 ** 0.5
    bound = 2.0 / 128 ** 0.5 / 0.8796 + 1e-6
    assert float(m.weight.detach().abs().max()) <= bound
    # masked weights do not reach the output
    y = m(torch.ones(2, 128))
    assert y.shape == (2, 256)
    assert torch.allclose(y, torch.ones(2, 128) @ (m.weight * m.mask).T,
                          atol=1e-5)


def test_model_with_flax_weights_matches_flax():
    model, variables = flax_model()
    port = carried(variables)
    x = inputs()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(model.apply(variables, jnp.asarray(x))))


def test_extract_linears_equals_jax():
    _, variables = flax_model(seed=1)
    got = extract_linears(carried(variables))
    want = jextract_linears(variables)
    assert [n for n, _, _ in got] == ["fc1", "fc2", "fc3"]
    assert len(got) == len(want) == 3
    for (_, w, b), (_, jw, jb) in zip(got, want):
        assert w.dtype == np.float32 and w.shape == jw.shape
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(b, jb)
    shapes = [w.shape for _, w, _ in got]
    assert shapes == [(HIDDEN, IN), (HIDDEN, HIDDEN), (OUT, HIDDEN)]


def test_layer_manager_matches_jax_and_flax():
    model, variables = flax_model()
    jaccel = JManager().replace_layers(variables)
    mgr = AcceleratorLayerManager(Accelerator(device="cpu"))
    accel = mgr.replace_layers(carried(variables))
    assert isinstance(accel, AcceleratedModel)
    assert mgr.layer_names == ["fc1", "fc2", "fc3"]
    assert ([h.format for h, _ in accel.layers]
            == [h.format for h, _ in jaccel.layers])
    assert accel.layers[0][0].format == "dense"
    x = inputs()
    got = accel(x)
    assert got.device.type == "cpu" and got.shape == (4, OUT)
    assert_close(got.numpy(), np.asarray(jaccel(x)))
    stats = compare_model_outputs(got, model.apply(variables,
                                                   jnp.asarray(x)))
    assert stats.ok, (stats.num_mismatches, stats.max_rel_error)


def test_layer_manager_on_a_torch_model():
    torch.manual_seed(0)
    model = ThreeLayerFCModel(IN, HIDDEN, OUT, DENSITY,
                              generator=torch.Generator().manual_seed(5))
    accel = AcceleratorLayerManager(Accelerator(device="cpu")).replace_layers(
        model)
    x = torch.from_numpy(inputs(6, seed=4))
    with torch.no_grad():
        want = model(x)
    assert compare_model_outputs(accel(x), want).ok
    # a single input vector goes through as [C] -> [OUT]
    assert compare_model_outputs(accel(x[0]), want[0]).ok


def test_manager_budget_error():
    _, variables = flax_model(seed=4)
    mgr = AcceleratorLayerManager(Accelerator(budget_bytes=64, device="cpu"))
    with pytest.raises(MemoryError):
        mgr.replace_layers(carried(variables))


def test_demo_main_on_cpu(capsys):
    assert demo.main(["--device", "cpu", "--batch-size", "3",
                      "--input-size", "64", "--hidden-size", "256",
                      "--output-size", "48"]) == 0
    out = capsys.readouterr().out
    assert "formats per layer" in out and "PASS" in out
