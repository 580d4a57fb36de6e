"""The port's GPipe pipeline over the ``pod`` axis
(``repro_torch.distributed.pipeline``) against the JAX package, the twin
of ``tests/test_pipeline.py``.

One JAX subprocess (two forced host devices) runs the reference's
``pipeline_apply`` on a ``("pod",)`` mesh of 2 and its gradient; four
gloo ranks run the port's on the ``pod`` axis of a (2, 2) ``(pod, data)``
mesh, each spawned once for the module.  Tolerances: the outputs within
1e-6 of the reference's and of the sequential composition's (the same
fp32 operations, expect 0); each rank's stage gradients finite, non-zero
and within 1e-6 of the sequential composition's autograd gradients.  The
reference's gradient is not compared: under JAX 0.9.0 ``jax.grad`` of its
``pipeline_apply`` on two forced host devices raises ("Length of device
assignment 1 is not equal to the size of the mesh 2"), and its own
gradient test runs only with two devices.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.distributed.pipeline import split_stages as jsplit_stages  # noqa: E402

from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.pipeline import (pipeline_apply,  # noqa: E402
                                              split_stages)
from repro_torch.launch import mesh as MM  # noqa: E402

from test_torch_mesh_workers import _stage_fn, spawn  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# name -> (n_stages, n_micro, mb, d, seed): the reference test's two cases
CASES = {"sequential": (2, 4, 3, 8, 0), "gradients": (2, 2, 2, 4, 2)}

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
import numpy as np
from repro.distributed import sharding as shd
from repro.distributed.pipeline import pipeline_apply

def stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])

d = dict(np.load(sys.argv[1]))
out = {}
for name in sys.argv[3:]:
    params = {"w": d[name + ".w"], "b": d[name + ".b"]}
    x = d[name + ".x"]
    with shd.use_mesh(jax.make_mesh((2,), ("pod",))):
        out[name + ".y"] = np.asarray(pipeline_apply(stage_fn, params, x))
np.savez(sys.argv[2], **out)
"""


def _case(name):
    n_stages, n_micro, mb, d, seed = CASES[name]
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((n_stages, d, d)) * 0.5)
              .astype(np.float32),
              "b": (rng.standard_normal((n_stages, d)) * 0.1)
              .astype(np.float32)}
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return params, x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    cases = {name: dict(zip(("params", "x"), _case(name))) for name in CASES}
    np.savez(d / "in.npz", **{f"{n}.{k}": v for n, c in cases.items()
                              for k, v in [*c["params"].items(),
                                           ("x", c["x"])]})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), *CASES], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        ranks = spawn(("pipeline",), {"pipe": cases}, str(d / "ranks"))
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out.decode()[-3000:]
    return {"ranks": ranks, "ref": dict(np.load(d / "out.npz"))}


def _sequential(params, x):
    want = torch.from_numpy(x)
    for s in range(params["w"].shape[0]):
        want = _stage_fn({"w": torch.from_numpy(params["w"][s]),
                          "b": torch.from_numpy(params["b"][s])}, want)
    return want.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_matches_the_reference_and_sequential(world, name):
    params, x = _case(name)
    want = _sequential(params, x)
    for r in world["ranks"]:
        got = r["pipeline"][name]["y"]
        np.testing.assert_allclose(got, world["ref"][name + ".y"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_flow(world, name):
    stages = set()
    for r in world["ranks"]:
        got = r["pipeline"][name]
        stages.add(got["stage"])
        for g, seq in ((got["gw"], got["gw_seq"]), (got["gb"], got["gb_seq"])):
            assert np.isfinite(g).all() and np.abs(g).sum() > 0
            np.testing.assert_allclose(g, seq, rtol=0,
                                       atol=1e-6 * np.abs(seq).max())
    assert stages == {0, 1}


def test_split_stages():
    layers = {"w": np.arange(12).reshape(6, 2)}
    out = split_stages({"w": torch.from_numpy(layers["w"])}, 2)
    want = jsplit_stages({"w": jnp.asarray(layers["w"])}, 2)
    assert tuple(out["w"].shape) == want["w"].shape == (2, 3, 2)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(want["w"]))
    with pytest.raises(ValueError):
        split_stages({"w": torch.zeros(5, 2)}, 2)


def test_needs_the_pod_axis():
    params, x = _case("gradients")
    with pytest.raises(ValueError, match="pod"):
        pipeline_apply(_stage_fn, {k: torch.from_numpy(v)
                                   for k, v in params.items()},
                       torch.from_numpy(x))


def test_one_stage_mesh_is_the_stage():
    """On a 1-rank ``("pod",)`` mesh the pipeline is the one stage, bit
    for bit; its gradient sums the microbatches' in turn, so it is the
    stage's within 1e-6 of its max."""
    rng = np.random.default_rng(5)
    params = {"w": torch.from_numpy(rng.standard_normal((1, 4, 4))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((1, 4))
                                    .astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((3, 2, 4)).astype(np.float32))
    MM.init_single("cpu")
    try:
        with shd.use_mesh(MM.make_mesh((1,), ("pod",))):
            w = params["w"].clone().requires_grad_(True)
            y = pipeline_apply(_stage_fn, {"w": w, "b": params["b"]}, x)
            y.square().sum().backward()
    finally:
        MM.destroy()
    w2 = params["w"].clone().requires_grad_(True)
    want = _stage_fn({"w": w2[0], "b": params["b"][0]}, x)
    want.square().sum().backward()
    assert torch.equal(y, want)
    torch.testing.assert_close(w.grad, w2.grad, rtol=0,
                               atol=1e-6 * float(w2.grad.abs().max()))
