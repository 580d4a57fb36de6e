"""The port's launch layer (``repro_torch.launch.mesh`` and
``repro_torch.launch.dryrun``) against the JAX package's, the twin of
``tests/test_launch.py``'s mesh and dry-run cases.

- Meshes: ``make_production_mesh`` over fake process groups of 256 and
  512 ranks (this process rank 0), ``make_host_mesh`` over a gloo group
  of one or the running group; each group is ended after its test.
- ``input_specs``: every tensor's path and shape equal to the reference's
  ``ShapeDtypeStruct`` stand-ins, which one JAX subprocess writes for the
  module (the reference's dry run forces 512 host devices on import).
- One ``run_cell`` on meta (phi4-mini-3.8b, ``decode_32k``, ``single``)
  through ``main``: collectives recorded, FLOPs counted, and the per-rank
  argument bytes equal to the sum this test computes from the
  parameters' ``sharding_like`` blocks, the rows of the cache and the
  whole tokens.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, RunConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as MM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
SPEC_CELLS = [("glm4-9b", "train_4k"), ("glm4-9b", "prefill_32k"),
              ("glm4-9b", "decode_32k"), ("musicgen-medium", "train_4k")]

_JAX_SCRIPT = r"""
import json, sys
from repro.launch.dryrun import input_specs
from repro.configs.base import RunConfig
import jax

out = {}
for cell in json.loads(sys.argv[1]):
    _, _, args = input_specs(*cell, RunConfig())
    flat = jax.tree_util.tree_flatten_with_path(args)[0]
    out["|".join(cell)] = {jax.tree_util.keystr(p): list(l.shape)
                           for p, l in flat}
json.dump(out, open(sys.argv[2], "w"))
"""


def _paths(tree, path=""):
    """``{keystr path: shape}`` of the tensors of a nested dict / tuple,
    in ``jax.tree_util.keystr``'s spelling."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _paths(tree[key], f"{path}[{key!r}]").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree)
                for k, v in _paths(item, f"{path}[{i}]").items()}
    if isinstance(tree, torch.Tensor):
        return {path: list(tree.shape)}
    return {}


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                        json.dumps(SPEC_CELLS), str(out)], env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    return json.loads(out.read_text())


@pytest.fixture()
def fake():
    """``fake(world)``: a fake group of ``world`` ranks, ended after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world):
        torch.distributed.init_process_group("fake", store=FakeStore(),
                                             rank=0, world_size=world)

    try:
        yield start
    finally:
        MM.destroy()


class TestMesh:
    @pytest.mark.parametrize("multi,world,shape,names", [
        (False, 256, (16, 16), ("data", "model")),
        (True, 512, (2, 16, 16), ("pod", "data", "model"))])
    def test_production_mesh(self, fake, multi, world, shape, names):
        fake(world)
        m = MM.make_production_mesh(multi_pod=multi)
        assert tuple(m.mesh.shape) == shape
        assert m.mesh_dim_names == names
        assert shd.axis_sizes(m) == dict(zip(names, shape))

    def test_host_mesh(self):
        try:
            m = MM.make_host_mesh("cpu")
            assert m.mesh_dim_names == ("data",)
            assert torch.distributed.get_backend() == "gloo"
            assert tuple(m.mesh.shape) == (1,)
        finally:
            MM.destroy()
        assert not torch.distributed.is_initialized()

    def test_host_mesh_takes_the_running_group(self, fake):
        fake(4)
        m = MM.make_host_mesh("cpu")
        assert tuple(m.mesh.shape) == (4,)


class TestInputSpecs:
    @pytest.mark.parametrize("cell", SPEC_CELLS, ids="|".join)
    def test_shapes_are_the_reference(self, ref_specs, cell):
        _, sh, args = dryrun.input_specs(*cell, RunConfig())
        got = _paths(args)
        want = ref_specs["|".join(cell)]
        # the port's caches keep each group's lengths and the step as
        # Python ints, and a train step takes its noise source (None on
        # meta) where the reference takes a PRNG key
        want = {k: v for k, v in want.items()
                if "['len']" not in k and k not in ("[2]['step']", "[2]")}
        assert got == want
        leaves = [t for t in _flat(args) if isinstance(t, torch.Tensor)]
        assert all(t.device.type == "meta" for t in leaves)
        if sh.kind == "train":
            assert next(iter(args[1].values())).shape[:2] == \
                (sh.global_batch, sh.seq_len)

    def test_long_500k_only_subquadratic(self):
        assert {a for a in configs.ARCH_NAMES
                if "long_500k" in configs.cells(a)} == {"rwkv6-7b",
                                                        "zamba2-2.7b"}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


class TestCollectives:
    def test_recorded_per_op_with_the_reference_factors(self, fake):
        """The helpers' counts and bytes per rank, as the reference's
        ``parse_collectives`` counts HLO ops: all-reduce at twice its
        result, the others at their result."""
        fake(4)
        with shd.use_mesh(MM.make_mesh((2, 2), ("data", "model"))), \
                shd.record_collectives() as log:
            x = torch.empty((16, 1024), dtype=torch.bfloat16, device="meta")
            shd.all_gather(x, "model", dim=0)
            shd.all_reduce(torch.empty(256, device="meta"), "data")
            shd.reduce_scatter(torch.empty(4, 4, device="meta"), "data",
                               dim=0)
            shd.all_gather(x, "data", dim=0)
        assert log["counts"] == {"all-gather": 2, "all-reduce": 1,
                                 "reduce-scatter": 1}
        assert log["bytes_per_op"]["all-reduce"] == 256 * 4 * 2
        assert log["bytes_per_op"]["all-gather"] == 2 * 32 * 1024 * 2
        assert log["bytes_per_op"]["reduce-scatter"] == 2 * 4 * 4
        assert log["total_bytes"] == sum(log["bytes_per_op"].values())

    def test_nothing_moves_on_a_one_rank_mesh(self):
        MM.init_single("cpu")
        try:
            with shd.use_mesh(MM.make_mesh((1, 1), ("data", "model"))), \
                    shd.record_collectives() as log:
                x = torch.ones(4, 4)
                assert shd.all_gather(x, "model", dim=0) is x
                assert shd.all_reduce(x, ("data", "model")) is x
        finally:
            MM.destroy()
        assert log["counts"] == {} and log["total_bytes"] == 0


class TestDryRun:
    def test_decode_cell_on_meta(self, tmp_path):
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
        r = json.loads((tmp_path / "phi4-mini-3.8b__decode_32k__single__"
                        "digital.json").read_text())
        assert r["n_devices"] == 256 and r["kind"] == "decode"
        assert r["collectives"]["counts"].get("all-gather", 0) > 0
        assert r["collectives"]["total_bytes"] > 0
        assert r["cost"]["flops"] > 0
        assert r["memory"]["temp_size_in_bytes"] is None
        assert not torch.distributed.is_initialized()
        assert r["memory"]["argument_size_in_bytes"] == _decode_arg_bytes()

    def test_main_needs_a_cell(self):
        with pytest.raises(SystemExit):
            dryrun.main([])


def _decode_arg_bytes() -> int:
    """This rank's argument bytes of phi4-mini's decode_32k step on the
    16 x 16 mesh, from the shapes: each parameter's block (the dims its
    ``sharding_like`` spec splits, divided by the axes' sizes), the
    cache's block (its rows over ``data``, and its sequence over
    ``model``: phi4-mini's 8 KV heads do not divide 16) and the whole
    [B, 1] tokens."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = configs.get_arch("phi4-mini-3.8b")
    sh = SHAPES["decode_32k"]
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=256)
    try:
        with shd.use_mesh(MM.make_production_mesh(),
                          rules=shd.rules_for(RunConfig())):
            params = T.lm_init(torch.Generator(), cfg, device="meta")
            sizes = shd.axis_sizes()
            total = 0
            for t, ns in zip(_flat(params), _flat(shd.sharding_like(
                    T.lm_specs(cfg), params))):
                n = t.numel()
                for entry in ns.spec:
                    for a in ([entry] if isinstance(entry, str)
                              else entry or ()):
                        n //= sizes[a]
                total += n * t.element_size()
    finally:
        MM.destroy()
    cache = T.init_lm_cache(cfg, sh.global_batch // 16, sh.seq_len // 16,
                            device="meta")
    total += sum(t.numel() * t.element_size() for t in _flat(cache)
                 if isinstance(t, torch.Tensor))
    return total + sh.global_batch * 8
