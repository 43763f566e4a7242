"""Multi-pod dry run: every (arch x shape x mesh) cell built, captured and
priced on the H100, the JAX package's ``launch/dryrun.py`` over
``torch.distributed`` ranks.

For each cell this shows, without the ranks:
  * the sharding is coherent (the model and the step build on the
    production mesh: TP + EP over ``model``, FSDP over the data axes for
    the large archs, ZeRO-1 or Adafactor),
  * the step runs through (the capture: one pass of the step, rank 0's
    view, under fake tensors and a fake process group of the mesh's size),
  * whether it fits the card's memory,
  * and its roofline terms on the H100 (``core.params.H100``, 80 GB):
    modelled times, not measured ones.

The reference lowers and compiles with XLA and reads the compiled
program's memory and cost analyses; here ``core.graph.capture`` records
the same quantities from one pass over fake tensors.  What each record key
holds in the port:

* ``memory.argument_bytes``: the step's arguments on rank 0 (its
  parameter blocks, the optimizer state, its rows of the batch, the decode
  caches); ``output_bytes``: what it returns (the arguments it updates in
  place, and the logits, caches or metrics it makes); ``alias_bytes``: the
  arguments updated in place (parameters and state of a train step, the
  caches of a decode step: the reference's donated buffers);
  ``temp_bytes``: the peak of the storages the pass made and held
  (``CapturedStep.peak_bytes``), less the outputs among them;
  ``live_bytes`` = argument + temp + output - alias, as the reference's.
* ``cpu_f32_twin_bytes`` is 0: there are no XLA CPU float32 twins of
  bfloat16 buffers to take away.  ``live_bytes_tpu_estimate`` is renamed
  ``live_bytes_device_estimate`` (the one renamed key).
* ``cost_raw``: the capture's flops and unfused bytes; ``roofline``:
  ``core.hlo.RooflineTerms`` on the H100 of those flops, the analytic HBM
  bytes (``core.analytic.cell_summary``, as the reference) and the
  captured collectives' wire bytes; ``parsed_hbm_bytes_upper`` is the
  capture's unfused byte count.
* ``collectives``: the captured collectives by kind (count and wire
  bytes): the all-gathers and reduce-scatters of FSDP, the all-reduces of
  TP, EP and the data ranks, as ``parallel.transport`` runs them.
* ``lower_s``: the build and the capture pass (a train step's
  microbatches folded into one, ``core.graph.folded``: the same record);
  ``compile_s``: tracing the step's ``make_fx`` graph, whose code is saved
  gzipped beside each record (``<mesh>/graph/<arch>__<shape>.py.gz``)
  where the reference saves HLO.  The trace costs several times the
  capture, so the CLI makes it only with ``--graphs``; without it
  ``compile_s`` is 0.0.

Uneven blocks (kv heads under ``sharding.head_split``) differ from rank
to rank; the record is rank 0's.  A decode cell's caches are the
reference's ``cache_pspecs`` blocks (``sharding.cache_block``: the
batch's rows over the data axes where it divides them, the kv heads over
``model`` where they split, else L over ``model``; a ``long_500k`` cell's
batch of 1 stays whole on every data rank, as in ``batch_pspecs``, and
its L is split over the data axes too), so its ``memory.*`` and
fits-80-GB verdicts count the reference's bytes; a prefill cell keeps its
block of the caches it makes.  ``layout="fsdp_seq"`` (pure FSDP over every rank with
the sequence split over ``model``, ``sharding.fsdp_seq_specs``) builds the
same three steps; its rank 0 holds the first block of the positions, which
attends the fewest keys (the record is that rank's), and decode's new
token is written by the last rank.  ``launch.perf_cell`` captures one cell
with overrides and prints its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape decode_32k
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import (ARCHS, PORT_ONLY, SHAPES, cell_applicable, get_arch,
                       get_shape)
from ..core import analytic, graph
from ..core.hlo import RooflineTerms
from ..core.params import H100
from ..models import factory
from ..models.blocks import init_caches
from ..models.config import ArchConfig, ShapeConfig
from ..models.convert import reference_leaves
from ..parallel import sharding
from ..train.loop import local_batch, make_train_step
from ..train.optimizer import (AdamWConfig, adafactor_init, adamw_init,
                               zero1_blocks)
from .mesh import init_fake_ranks, make_production_mesh

MODEL_AXIS_NAME = "model"

DEFAULT_OUT = pathlib.Path("experiments/dryrun_torch")


def _mesh_name(mesh) -> str:
    sizes = sharding.axis_sizes(mesh)
    return "x".join(str(sizes[a]) for a in mesh.mesh_dim_names)


def dp_of(mesh) -> int:
    dp = 1
    for a, n in sharding.axis_sizes(mesh).items():
        if a != "model":
            dp *= n
    return dp


#: Residual-activation budget per device (the remat'd stack's carry):
#: n_layers x (tokens_micro/device) x d_model x 2 B must stay under this.
RESIDUAL_BUDGET_BYTES = 4.0e9


def default_n_micro(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Microbatch count from the activation-residency napkin math: the
    smallest divisor of the per-device batch whose residuals (one
    (tokens, d_model) bf16 tensor per layer) fit the budget."""
    per_dev = max(1, shape.global_batch // dp_of(mesh))
    full = cfg.n_layers * per_dev * shape.seq_len * cfg.d_model * 2.0
    need = max(1, int(-(-full // RESIDUAL_BUDGET_BYTES)))
    for m in range(need, per_dev + 1):
        if per_dev % m == 0:
            return m
    return per_dev


#: FSDP + TP hybrid for archs whose parameters a ``model`` rank holds
#: exceed these bytes; serving has no optimizer state, so its threshold is
#: laxer (and FSDP at decode costs a gather a layer a token).
FSDP_TRAIN_BYTES, FSDP_SERVE_BYTES = 1.0e9, 7.0e9


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _abstract_like(x: torch.Tensor, device) -> torch.Tensor:
    return graph.abstract(torch.empty, tuple(x.shape), dtype=x.dtype,
                          device=device)


class Step:
    """One cell's step: ``step(*args)`` runs it (on a mesh of real ranks)
    and ``capture`` records it; ``donated`` names the arguments it updates
    in place, ``model`` is the model it runs."""

    def __init__(self, fn, kind: str, donated: tuple, model):
        self.fn, self.kind, self.donated = fn, kind, donated
        self.model = model
        self.__name__ = f"{kind}_step"

    def __call__(self, *args):
        return self.fn(*args)


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
               opt_cfg: AdamWConfig | None = None, zero1: bool = True,
               n_micro: int | None = None, layout: str = "tp",
               moe_impl: str | None = None, device="cuda",
               abstract: bool = False):
    """Returns ``(step, args, meta)`` for one cell on ``mesh``.

    train   -> the train step (forward + backward + AdamW or Adafactor),
               microbatched, over the global batch
    prefill -> ``model.prefill`` of this rank's rows over the whole sequence
    decode  -> ``model.decode_step`` of this rank's rows with a
               ``seq_len`` cache

    ``meta``: ``fsdp``, ``n_micro`` and (train) ``optimizer``, decided as
    the reference decides them.  The model is built without the kernels,
    its weights from seed 0 on ``device`` (the train launcher's);
    ``abstract``: every weight and argument a fake tensor
    (``core.graph.abstract``), nothing drawn or allocated, for
    :func:`run_cell`'s capture.

    ``layout``: ``"tp"`` (TP + EP over ``model``, FSDP over the data axes
    for the large archs) or ``"fsdp_seq"`` (pure FSDP over data x model,
    the sequence split over ``model``: ``models.lm.LanguageModel``; FSDP
    always, the optimizer and the microbatches decided as under ``"tp"``).
    ``moe_impl``: ``"ep_local"`` under ``"tp"`` and ``"scatter"`` under
    ``"fsdp_seq"`` when ``None`` (``"ep_local"`` there raises)."""
    if layout not in ("tp", "fsdp_seq"):
        raise ValueError(f"unknown layout {layout!r}; 'tp' or 'fsdp_seq'")
    seq = layout == "fsdp_seq"
    if moe_impl is None:
        moe_impl = "scatter" if seq else "ep_local"
    # blockwise attention stays rank-local for prefill via KV expansion
    # and TP-aligned head padding (the reference's confirmed defaults)
    if shape.kind == "prefill" and cfg.n_heads and cfg.n_kv_heads:
        cfg = cfg.replace(attn_expand_kv=True, head_pad_multiple=16)
    dev = torch.device(device) if abstract else factory.torch_device(device)
    # the data axes' group (of a flattened sub-mesh on the multi-pod mesh)
    # is made on first use, which must not be under the fake mode
    sharding.axes_group(mesh, sharding.data_axes(mesh))
    if seq:
        sharding.axes_group(mesh, sharding.seq_axes(mesh))
    whole = factory.abstract_leaves(cfg)
    threshold = FSDP_TRAIN_BYTES if shape.kind == "train" \
        else FSDP_SERVE_BYTES
    _, used_fsdp = sharding.fsdp_pspecs(whole, sharding.param_pspecs(whole),
                                        mesh, threshold=threshold)
    used_fsdp = used_fsdp or seq

    def build():
        gen = torch.Generator(device=dev).manual_seed(0)
        return factory.make_model(cfg, moe_impl=moe_impl, device=dev,
                                  generator=gen, mesh=mesh, fsdp=used_fsdp,
                                  layout=layout)

    model = graph.abstract(build) if abstract else build()
    params = reference_leaves(model)
    inputs = factory.make_inputs(cfg, shape, abstract=True)
    batch = {k: _abstract_like(x, dev) for k, x in inputs.items()} \
        if abstract else factory.make_inputs(cfg, shape, device=dev)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        # 100B+ archs: Adafactor (factored second moment) + bf16 gradient
        # accumulation; AdamW + ZeRO-1 otherwise
        n_params = sum(math.prod(leaf.shape) for leaf in whole)
        big = n_params > 1e11
        low_dtype = torch.bfloat16 if big else torch.float32
        optimizer = "adafactor" if big else "adamw"
        if big:
            init = lambda: adafactor_init(params)
        else:
            blocks = zero1_blocks(params, mesh) if zero1 else None
            init = lambda: adamw_init(params, low_dtype, blocks=blocks)
        ostate = graph.abstract(init) if abstract else init()
        # the step count stays a real host scalar: the schedule's input
        ostate["count"] = torch.zeros((), dtype=torch.int32)
        if n_micro is None:
            n_micro = default_n_micro(cfg, shape, mesh)
        fn = make_train_step(model.loss, opt_cfg, n_micro=n_micro,
                             accum_dtype=low_dtype, optimizer=optimizer,
                             mesh=mesh, zero1=zero1 and not big)
        return Step(fn, "train", (0, 1), model), (params, ostate, batch), {
            "fsdp": used_fsdp, "n_micro": n_micro, "optimizer": optimizer}

    if shape.kind == "prefill":
        rows = next(iter(local_batch(inputs, mesh).values())).shape[0]
        model.cache_block(rows, shape.seq_len, shape.global_batch)

        @torch.no_grad()
        def prefill_step(p, b):
            return model.prefill(local_batch(b, mesh), max_len=shape.seq_len,
                                 global_batch=shape.global_batch)
        return Step(prefill_step, "prefill", (), model), (params, batch), {
            "fsdp": used_fsdp, "n_micro": 1}

    # decode: this rank's rows of the batch, its block of each cache (the
    # block made here, outside the capture: its group is made on first use)
    mine = local_batch(inputs, mesh)
    rows = next(iter(mine.values())).shape[0]
    block = model.cache_block(rows, shape.seq_len, shape.global_batch)

    def caches_of():
        return init_caches(cfg, rows, shape.seq_len, dev, model.tp,
                           model.seq, block)
    caches = graph.abstract(caches_of) if abstract else caches_of()

    @torch.no_grad()
    def decode_step(p, c, b, pos):
        return model.decode_step(c, local_batch(b, mesh), pos,
                                 max_len=shape.seq_len,
                                 global_batch=shape.global_batch)
    return Step(decode_step, "decode", (1,), model), \
        (params, caches, batch, shape.seq_len - 1), \
        {"fsdp": used_fsdp, "n_micro": 1}


def _arg_tensors(arg) -> list:
    """The tensors of one step argument (leaves, a state dict, a batch,
    caches)."""
    from torch.utils import _pytree as pytree
    if isinstance(arg, list) and arg and hasattr(arg[0], "tensors"):
        return [t for leaf in arg for t in leaf.tensors]
    return [t for t in pytree.tree_leaves(arg)
            if isinstance(t, torch.Tensor)]


def _memory(step: Step, args, captured, mesh) -> dict:
    """The record's ``memory`` block (module docstring)."""
    batch = {"train": 2, "prefill": 1, "decode": 2}[step.kind]
    own = [_nbytes(_arg_tensors(local_batch(a, mesh) if i == batch else a))
           for i, a in enumerate(args)]           # rank 0's rows of a batch
    argument = sum(own)
    alias = sum(own[i] for i in step.donated)
    output = alias + captured.new_output_bytes
    temp = max(0, captured.peak_bytes - captured.new_output_bytes)
    live = argument + temp + output - alias
    return {"argument_bytes": int(argument), "output_bytes": int(output),
            "temp_bytes": int(temp), "alias_bytes": int(alias),
            "live_bytes": int(live)}


def run_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
             save_hlo_dir: pathlib.Path | None = None,
             n_micro: int | None = None, fold: bool = True,
             layout: str = "tp", moe_impl: str | None = None,
             retry: bool = True) -> dict:
    """Build and capture one cell on ``mesh`` (rank 0's view; the process
    group must be the mesh's, a fake one of its size will do); returns its
    record.  ``save_hlo_dir``: trace the step's graph and save its code
    there, gzipped (``compile_s`` is 0.0 without it).  ``fold``: capture
    one microbatch of a train step and count it ``n_micro`` times
    (``core.graph.folded``), the same record as the unrolled capture's.
    ``layout`` and ``moe_impl``: :func:`build_step`'s.

    Training cells that exceed the card's memory retry with doubled
    microbatching (adaptive activation-residency tuning) before reporting
    a misfit (``retry=False``: they report it)."""
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": _mesh_name(mesh),
           "kind": shape.kind, "status": "ok"}
    t0 = time.time()
    step, args, meta = build_step(cfg, shape, mesh, n_micro=n_micro,
                                  layout=layout, moe_impl=moe_impl,
                                  device="cpu", abstract=True)
    rec.update(meta)
    captured = graph.capture(step, *args, name=f"{cfg.name}__{shape.name}",
                             fold=fold)
    rec["lower_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    text = captured.as_text() if save_hlo_dir is not None else None
    rec["compile_s"] = round(time.time() - t1, 2)

    rec["memory"] = _memory(step, args, captured, mesh)
    del step, args
    live = rec["memory"]["live_bytes"]
    rec["cost_raw"] = {"flops": captured.flops,
                       "bytes_accessed": captured.bytes}
    colls = captured.collectives()
    wire = sum(op.total_wire_bytes for op in colls)
    rec["memory"]["cpu_f32_twin_bytes"] = 0
    rec["memory"]["live_bytes_device_estimate"] = int(live)
    dp, tp = dp_of(mesh), sharding.axis_sizes(mesh)[MODEL_AXIS_NAME]
    foot = analytic.analytic_live_bytes(
        cfg, shape, dp, tp, n_micro=rec.get("n_micro", 1),
        fsdp=rec.get("fsdp", False),
        optimizer=rec.get("optimizer", "adamw"))
    rec["memory"]["analytic_live_bytes"] = {k: int(v)
                                            for k, v in foot.items()}
    rec["memory"]["fits_hbm_parsed"] = bool(live <= H100.hbm_bytes)
    rec["memory"]["fits_hbm"] = bool(
        min(live, foot["total"]) <= H100.hbm_bytes)

    n_micro = rec.get("n_micro", 1)
    summary = analytic.cell_summary(cfg, shape, dp, tp, n_micro=n_micro)
    rec["analytic"] = summary
    terms = RooflineTerms(flops=captured.flops,
                          hbm_bytes=summary["analytic_hbm_bytes"],
                          wire_bytes=wire, spec=H100)
    rec["roofline"] = terms.as_dict()
    rec["roofline"]["parsed_hbm_bytes_upper"] = captured.bytes
    rec["roofline"]["model_flops_per_chip"] = summary["model_flops_per_chip"]
    rec["roofline"]["useful_flops_ratio"] = (
        summary["model_flops_per_chip"] / captured.flops
        if captured.flops else 0.0)
    by_kind = {}
    for op in colls:
        k = by_kind.setdefault(op.kind, {"count": 0, "wire_bytes": 0.0})
        k["count"] += max(1, int(round(op.multiplier)))
        k["wire_bytes"] += op.total_wire_bytes
    rec["collectives"] = by_kind
    del captured

    # adaptive retry: a training cell that misses the card's memory
    # doubles its microbatch count (up to one sequence per device)
    if retry and shape.kind == "train" and not rec["memory"]["fits_hbm"]:
        per_dev = max(1, shape.global_batch // dp)
        cur = rec.get("n_micro", 1)
        if cur < per_dev:
            again = run_cell(cfg, shape, mesh, save_hlo_dir=save_hlo_dir,
                             n_micro=min(per_dev, cur * 2), fold=fold,
                             layout=layout, moe_impl=moe_impl)
            again.setdefault("retries", []).append(
                {"n_micro": cur,
                 "live_bytes_device_estimate":
                     rec["memory"]["live_bytes_device_estimate"]})
            return again

    if save_hlo_dir is not None:
        save_hlo_dir.mkdir(parents=True, exist_ok=True)
        with gzip.open(save_hlo_dir / f"{cfg.name}__{shape.name}.py.gz",
                       "wt") as f:
            f.write(text)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--graphs", action="store_true",
                    help="also trace each step's graph and save its code "
                    "(several times the capture)")
    args = ap.parse_args(argv)

    pods = [False, True] if args.both_meshes else [args.multi_pod]
    # "all": the archs of the JAX package's dry run (a port-only arch runs
    # whole on one device: configs.PORT_ONLY)
    archs = [c for n, c in ARCHS.items() if n not in PORT_ONLY] \
        if args.arch == "all" else [get_arch(args.arch)]
    shapes = list(SHAPES.values()) if args.shape == "all" \
        else [get_shape(args.shape)]

    out_root = pathlib.Path(args.out)
    failures = 0
    for multi_pod in pods:
        init_fake_ranks(512 if multi_pod else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            failures += _run_mesh(mesh, archs, shapes, out_root,
                                  args.graphs)
        finally:
            dist.destroy_process_group()
    print(f"\ndry-run complete; {failures} failures")
    return 1 if failures else 0


def _run_mesh(mesh, archs, shapes, out_root: pathlib.Path,
              graphs: bool = False) -> int:
    """Every cell of ``archs`` x ``shapes`` on ``mesh``, a record each
    under ``out_root/<mesh>/``; returns the failures."""
    mdir = out_root / _mesh_name(mesh)
    mdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for cfg in archs:
        for shape in shapes:
            cell = f"{cfg.name} x {shape.name} @ {_mesh_name(mesh)}"
            if not cell_applicable(cfg, shape):
                rec = {"arch": cfg.name, "shape": shape.name,
                       "mesh": _mesh_name(mesh), "status": "skipped",
                       "reason": "full-attention arch; long_500k is "
                                 "sub-quadratic-only per assignment"}
                print(f"[skip] {cell}")
            else:
                try:
                    rec = run_cell(cfg, shape, mesh, save_hlo_dir=(
                        mdir / "graph" if graphs else None))
                    r, m = rec["roofline"], rec["memory"]
                    print(f"[ok]   {cell}: dominant={r['dominant']} "
                          f"compute={r['compute_s']:.3e}s "
                          f"memory={r['memory_s']:.3e}s "
                          f"collective={r['collective_s']:.3e}s "
                          f"live={m['live_bytes'] / 1e9:.2f}GB "
                          f"fits={m['fits_hbm']} "
                          f"(capture {rec['lower_s']}s, graph "
                          f"{rec['compile_s']}s)", flush=True)
                except Exception as e:
                    failures += 1
                    rec = {"arch": cfg.name, "shape": shape.name,
                           "mesh": _mesh_name(mesh), "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[FAIL] {cell}: {type(e).__name__}: {e}",
                          flush=True)
            fname = f"{cfg.name}__{shape.name}.json"
            (mdir / fname).write_text(json.dumps(rec, indent=2))
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
