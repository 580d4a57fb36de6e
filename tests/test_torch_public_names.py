"""The reference's public names in the port, each held against the
reference on the CPU: ``ArchConfig.param_count`` /
``active_param_count`` / ``attention_free`` for all ten configs, FULL
and SMOKE (equal integers and flags); ``CompiledModel.relower`` (the
relowered plans' codes and tables bit-exact against the reference's
relower of the same numpy parameters), ``ModuleSpec.layer`` /
``layer_names`` / ``group_members`` (equal names; an unknown layer
raises ``KeyError`` in both), on the ECG spec and a SMOKE LM spec;
``data.preprocess.preprocess_batch`` (bit-exact codes) and
``core.quant.dequantize_act`` / ``dequantize_weight`` (bit-exact
products)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.data.preprocess import preprocess_batch as jpreprocess_batch  # noqa: E402
from repro.models import ecg as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.data.preprocess import preprocess_batch  # noqa: E402
from repro_torch.models import ecg as E  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

LM = "phi4-mini-3.8b"


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_counts_and_attention_free_match_the_reference(name, size):
    get = "get_arch" if size == "full" else "get_smoke"
    cfg, jcfg = getattr(configs, get)(name), getattr(jconfigs, get)(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.attention_free is jcfg.attention_free


def test_param_counts_of_the_full_dense_configs():
    """The published sizes of the two configs this repo names by them."""
    glm, mini = configs.get_arch("glm4-9b"), configs.get_arch("minitron-4b")
    assert round(glm.param_count() / 1e9, 2) == 9.40
    assert round(mini.param_count() / 1e9, 2) == 4.19
    assert glm.active_param_count() == glm.param_count()
    moe = configs.get_arch("qwen3-moe-30b-a3b")
    assert moe.active_param_count() < moe.param_count() / 5


@functools.lru_cache(maxsize=None)
def _ecg(seed):
    jp = jax.jit(JE.ecg_init)(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _lm(seed):
    jp = jax.jit(lambda k: JT.lm_init(k, jconfigs.get_smoke(LM)))(
        jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _specs(kind):
    if kind == "ecg":
        return (JE.ecg_module_spec(), E.ecg_module_spec())
    jp, tp = _lm(0)
    return (JT.lm_module_spec(jconfigs.get_smoke(LM), jp),
            T.lm_module_spec(configs.get_smoke(LM), tp))


@pytest.mark.parametrize("kind", ["ecg", "lm"])
def test_spec_layer_names_and_group_members_match_the_reference(kind):
    jspec, spec = _specs(kind)
    assert spec.layer_names() == jspec.layer_names()
    assert len(spec.layer_names()) > 0
    assert spec.group_members() == jspec.group_members()
    assert all(isinstance(m, tuple) for m in spec.group_members().values())
    for name in spec.layer_names():
        assert spec.layer(name).name == jspec.layer(name).name == name
        assert spec.layer(name).group == jspec.layer(name).group
    for s in (spec, jspec):
        with pytest.raises(KeyError, match="no layer"):
            s.layer("no-such-layer")


def _stores(tree, path=""):
    """(path, plan) of every per-layer plan of a lowered artifact of
    either package (a stack's layers, or a tree's ``_plan`` entries; the
    port's scan-stacked ``PlanStack`` of member plans where the
    reference has one plan with stacked leaves)."""
    if hasattr(tree, "layers") and not isinstance(tree, dict):
        for i, lp in enumerate(tree.layers):
            yield f"{path}[{i}]", lp
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k == "_plan":
                yield path, v
            elif k != "_groups":
                yield from _stores(v, f"{path}.{k}")


def _field(plan, name):
    """A store field as a float32 numpy array, members stacked."""
    if isinstance(plan, tuple):
        return np.stack([_field(m, name) for m in plan])
    t = getattr(plan.store, name)
    if t is None:
        return None
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t.astype(np.float32)


@pytest.mark.parametrize("kind", ["ecg", "lm"])
def test_relower_matches_the_reference(kind):
    """The relower of new parameters equals the reference's relower and
    a fresh compile of them, codes and tables bit for bit, the
    calibration and device kept."""
    jspec, spec = _specs(kind)
    (jp0, tp0), (jp1, tp1) = ((_ecg(0), _ecg(1)) if kind == "ecg"
                              else (_lm(0), _lm(1)))
    jrun, run = (JAnalogConfig(mode="analog_faithful"),
                 AnalogConfig(mode="analog_faithful"))
    tm = api.compile(spec, tp0, run, device="cpu").relower(tp1)
    jm = japi.compile(jspec, jp0, jrun).relower(jp1)
    fresh = api.compile(spec, tp1, run, device="cpu")
    assert tm.device == torch.device("cpu") and tm.calibration is None
    got = dict(_stores(tm.lower()))
    want = dict(_stores(jm.lower()))
    again = dict(_stores(fresh.lower()))
    assert got.keys() == again.keys() == want.keys() and len(got) > 0
    for path, lp in got.items():
        for name in ("codes", "w_scale", "col_gain", "row_gain"):
            a, b = _field(lp, name), _field(want[path], name)
            if a is None:
                assert b is None, (path, name)
                continue
            np.testing.assert_array_equal(a, b.reshape(a.shape),
                                          err_msg=f"{path}.{name}")
            np.testing.assert_array_equal(a, _field(again[path], name))


def test_preprocess_batch_matches_the_reference():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 4096, (5, 2, 4033)).astype(np.float32)
    want = np.asarray(jpreprocess_batch(raw))
    got = preprocess_batch(raw, device="cpu")
    assert got.shape == want.shape == (5, 2, 126)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["act", "weight"])
def test_dequantize_matches_the_reference(which):
    rng = np.random.default_rng(1)
    if which == "act":
        code = rng.integers(0, 32, (4, 96)).astype(np.float32)
        scale = np.float32(0.0371)
    else:
        code = rng.integers(-63, 64, (96, 40)).astype(np.float32)
        scale = rng.uniform(1e-3, 1e-2, (1, 40)).astype(np.float32)
    jfn = getattr(jquant, f"dequantize_{which}")
    fn = getattr(quant, f"dequantize_{which}")
    want = np.asarray(jfn(jnp.asarray(code), jnp.asarray(scale)))
    got = fn(torch.from_numpy(code), torch.as_tensor(scale))
    np.testing.assert_array_equal(got.numpy(), want)
