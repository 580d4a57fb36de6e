"""Compiled analog programs (port of ``repro.api.program``):
:class:`CompiledModel` plus the single-layer :func:`apply_linear`, the
function every model matmul routes through.

    model = api.compile(spec, params, run_cfg)   # on the CUDA device
    y     = model.apply(x)                       # run the compiled program
    plan  = model.lower()                        # AnalogPlan / lowered tree
    model = model.relower(new_params)            # re-bake after a weight update
    model = model.with_calibration(snapshot)     # drift hot-swap, no lowering

Serving compiles once and replays the baked plans for every request;
training compiles (or relowers) inside the differentiated step, so the
HIL gradients reach the float masters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.exec.lower import lower_layer
from repro_torch.exec.run import run as run_plan
from repro_torch.exec.run import run_layer


def apply_linear(params: dict, x: torch.Tensor, cfg: AnalogConfig, *,
                 noise=None) -> torch.Tensor:
    """Apply one analog (or digital) linear layer: x [..., K] -> y [..., N].

    A pre-baked ``"_plan"`` entry (placed by
    :func:`repro_torch.api.compile.lower_tree`) is replayed directly;
    otherwise the layer is lowered for this call.  A baked plan whose
    static attributes disagree with the call-site config is ignored
    rather than run with the wrong encoding.  ``noise``: the layer's
    readout-noise source (:func:`repro_torch.exec.run.run_layer`).

    Under a mesh, a view marked row-parallel (``params["_tp"] == "row"``,
    :mod:`repro_torch.distributed.tensor_parallel`) holds this rank's
    ``K`` block: ``x`` (whole, or already this rank's block of its
    features) times the block, summed over the ``model`` axis."""
    if cfg.mode == "digital":
        w = params["w"]
        if tp.split_rows(params):
            k = w.shape[0]
            if x.shape[-1] != k:
                # a whole input every rank holds: its block, the
                # gradient summed over the ranks' blocks
                x = shd.psum_grad(x, shd.split_axes("model")).narrow(
                    -1, shd.axis_index("model") * k, k)
            # fp32 partial sums, rounded once after the all-reduce (a
            # bf16 activation would round each rank's partial first)
            y = shd.sum_over(torch.matmul(x.to(torch.float32),
                                          w.to(torch.float32)),
                             "model").to(x.dtype)
        else:
            y = torch.matmul(x, w.to(x.dtype))
        if "b" in params:
            y = y + params["b"].to(y.dtype)
        return y
    lp = params.get("_plan")
    if lp is not None and (lp.signed_input != cfg.signed_input
                           or lp.chunk_rows != cfg.chunk_rows):
        lp = None
    if lp is None:
        lp = lower_layer(params, cfg)
    return run_layer(lp, x, cfg, noise=noise)


@dataclasses.dataclass(frozen=True)
class CompiledModel:
    """An executable analog model: declaration + params + the baked plans,
    all on ``device``, and the calibration snapshot they were baked from
    (None: the oracle bake)."""

    spec: Any                      # ModuleSpec
    params: Any                    # the float master parameters
    run_cfg: Any                   # RunConfig or AnalogConfig
    lowered: Any                   # AnalogPlan | lowered tree | None (digital)
    device: torch.device
    calibration: Any = None        # CalibrationSnapshot | None

    @property
    def acfg(self) -> AnalogConfig:
        return getattr(self.run_cfg, "analog", self.run_cfg)

    def apply(self, *args, **kw):
        """Run the compiled program: the spec's host program
        (``spec.apply_fn(model, *args, **kw)``) when it declares one, else
        the layer chain (``(x, *, noise=None, megakernel="auto")``); a
        block spec takes ``x [batch, seq, d_model]`` and replays the whole
        block - one launch on the megakernel route, 4 dispatches per layer
        with ``megakernel=False``."""
        if self.spec.apply_fn is not None:
            return self.spec.apply_fn(self, *args, **kw)
        if self.spec.kind not in ("stack", "block"):
            raise ValueError(f"spec {self.spec.name!r} declares no apply_fn")
        return self.run_stack(*args, **kw)

    def run_stack(self, x: torch.Tensor, *, noise=None, megakernel="auto"
                  ) -> torch.Tensor:
        """Replay the layer chain or block (megakernel-routed when
        eligible; ``noise`` as in :func:`repro_torch.exec.run.run`), or in
        digital mode run the float reference chain: ``x @ w (+ b)`` per
        layer, ReLU between layers, the same flatten."""
        if self.lowered is not None:
            return run_plan(self.lowered, x, noise=noise,
                            megakernel=megakernel)
        if megakernel is True:
            raise ValueError(
                "megakernel=True, but: digital mode compiles no analog "
                "plan to megakernel")
        h = x
        n = len(self.spec.layers)
        for i, layer in enumerate(self.spec.layers):
            p = self.params.get(layer.name, self.params)
            h = apply_linear(p, h, self.acfg)
            if i < n - 1:
                h = torch.relu(h)
            if layer.flatten_out:
                h = h.reshape(h.shape[:-2] + (-1,))
        return h

    def lower(self):
        """The compiled artifact: the stack's AnalogPlan (None in digital
        mode), or the pre-lowered params tree (tree kind; the raw params
        in digital mode)."""
        return self.lowered

    def relower(self, params) -> "CompiledModel":
        """Re-bake the plans for updated parameters (one weight update =
        one relower; the spec, run config, calibration and device are
        reused)."""
        from repro_torch.api.compile import compile as _compile

        return _compile(self.spec, params, self.run_cfg,
                        calibration=self.calibration, device=self.device)

    def with_calibration(self, snapshot) -> "CompiledModel":
        """Hot-swap a refreshed calibration snapshot's measured tables into
        the baked plans (the drift refresh): the ``chunk_offset`` tables,
        and where a plan baked a measured gain table (``store.chunk_gain``)
        and the snapshot has one of its shape, that table.  Nothing is
        lowered (:func:`~repro_torch.exec.lower.lowering_count` does not
        move); an offset-only swap keeps every weight store and the
        megakernel's ``w_cat``, a changed gain table re-derives the
        affected stores' ``w_eff`` from their codes.  Stack plans swap by
        spec layer name, a block plan by its four dispatch names
        (``"qkv"``, ``"o"``, ``"up_gate"``, ``"down"``), tree plans by
        dotted path (scan-stacked plans take per-stack-member ``[S, C,
        N]`` tables)."""
        from repro_torch.api.compile import swap_calibration
        from repro_torch.exec.lower import plan_with_tables
        from repro_torch.exec.plan import AnalogPlan

        if self.lowered is None:
            return dataclasses.replace(self, calibration=snapshot)
        if isinstance(self.lowered, AnalogPlan):
            offs, gains = [], []
            for layer, lp in zip(self.spec.layers, self.lowered.layers):
                rec = snapshot.layer(layer.name)
                offs.append(None if rec is None else rec.chunk_offset)
                g = None if rec is None else rec.gain_table
                cg = lp.store.chunk_gain
                if (g is None or cg is None or lp.colsum is not None
                        or tuple(g.shape) != tuple(cg.shape)):
                    g = None
                gains.append(g)
            lowered = plan_with_tables(self.lowered, offs, gains)
        else:
            lowered = swap_calibration(self.lowered, snapshot)
        return dataclasses.replace(self, lowered=lowered,
                                   calibration=snapshot)

    def verify(self, *, strict: bool = False, cheap_only: bool = False):
        """Run the FULL static invariant rule set
        (:mod:`repro_torch.verify.invariants`) over this model's spec,
        lowered artifact and baked calibration - including the rules
        ``compile(..., verify=True)`` skips (the identity drift swap,
        sharding-spec coverage, the packed layout's one-chunk probe).
        Returns the tuple of :class:`repro_torch.verify.Diagnostic`
        records (empty = clean); ``strict=True`` raises
        :class:`repro_torch.verify.VerifyError` instead."""
        from repro_torch.verify import invariants as _inv

        diags = _inv.verify_model(self, cheap_only=cheap_only)
        if strict:
            _inv.check(diags)
        return diags

    def group_plan(self, name: str) -> Optional[Any]:
        """The lowered :class:`~repro_torch.exec.plan.GroupPlan` (a
        :class:`~repro_torch.exec.plan.PlanStack` of them for scan-stacked
        members) of a declared fusion group, or None when the group did
        not fuse under this config."""
        from repro_torch.api.module import group_parent

        g = self.spec.group(name)          # KeyError lists declared groups
        if self.spec.kind != "tree":
            return None
        parent, _ = group_parent(g)
        node = self.lowered
        for part in parent.split(".") if parent else ():
            node = node[part]
        return node.get("_groups", {}).get(g.local_name)

    # ------------------------------------------------------------ sharding
    def sharding_specs(self):
        """Logical-axis spec tree matching :meth:`lower`'s output - the
        baked plan leaves included, so a pre-lowered tree shards over a
        mesh exactly like ordinary params
        (:mod:`repro_torch.distributed.sharding`).  A stack or block model
        gets its plan's specs (None in digital mode, which compiles no
        plan)."""
        from repro_torch.exec.plan import AnalogPlan

        if self.spec.kind != "tree":
            if not isinstance(self.lowered, AnalogPlan):
                return None
            axes = [l.sharding for l in self.spec.layers]
            return shd.analog_plan_specs(self.lowered, axes)
        base = self.spec.param_axes
        if base is None:
            raise ValueError(f"spec {self.spec.name!r} carries no param_axes")
        if self.lowered is None:
            return base
        return shd.plan_specs_like(base, self.lowered)
