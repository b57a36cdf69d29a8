"""Multi-pod dry run (torch port of ``repro.launch.dryrun``): count every
(architecture x input-shape x mesh) cell against the production mesh and
derive its per-rank memory and roofline terms, without a card and without
a process group:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out results/dryrun_torch

Each cell writes one JSON (incrementally: the sweep is resumable).

The reference lowers and compiles each cell's step for 256 / 512 forced
host devices and reads XLA's memory and cost analyses and the HLO text.
The port runs **rank 0's step once on the ``meta`` device**, in a planned
world of the mesh's ranks (``distributed.planned``), on rank 0's blocks of
the state, caches and batch (``launch.shardings``' specs, cut by
``local_shape``), and counts it with ``roofline.walk``: every tensor is
a shape, no parameter is allocated, no card is touched, every collective
returns a meta tensor and records its ring-model bytes.

Record keys, against the reference's:
  * ``memory``: ``argument_bytes`` (the step's arguments: rank 0's state
    and batch, or parameters, caches and batch), ``output_bytes``,
    ``alias_bytes`` (outputs that are arguments' storages: the caches,
    written in place; a train step returns a new state and donates
    nothing), ``temp_bytes`` = peak live - arguments, ``peak_bytes`` =
    ``hbm_per_device_bytes`` (the walk's largest sum of live storages,
    arguments and outputs included: what the port's eager step holds), and
    ``fits_80gb`` (the reference's ``fits_16gb``, for this card);
  * ``roofline``: ``flops`` and ``hbm_bytes`` (the walk's GEMMs and bytes
    plus the kernels' ``work``), ``collective_bytes``, the three terms at
    the H100's peaks (``roofline.analysis``; GEMMs in bf16), ``dominant``,
    ``by_op`` and ``by_kernel`` (calls, FLOPs and bytes of each
    hand-written kernel);
  * ``model_flops_global``, ``counted_flops_global`` (the reference's
    ``hlo_flops_global``: counted FLOPs x ranks), ``useful_flops_ratio``,
    ``n_params_total``, ``n_params_active``, ``moment_dtype``;
  * ``count_s`` in place of ``lower_s`` / ``compile_s``.

No counterpart: ``roofline_xla_once`` (XLA's cost analysis, which counts a
loop body once: the walk has no loops to miscount), ``n_while`` /
``max_trip`` (Python loops run; nothing is inferred) and ``hlo_gz`` (there
is no HLO to archive).

A decode cell steps one token at position ``seq_len - 1`` (the last one
its cache holds: every slot live); the reference's position is traced.
ZeRO-3 parameters (``ZERO3_ARCHS``) are gathered over the data axes at
use, a layer at a time (``shardings.zero3_gather``), their gradients
reduce-scattered.  What the port does not run raises, and the cell
records the error: ``--sharding fsdp`` needs a gather of model-sharded
weights at use, which the port's forward does not do, and
``--pod-compress`` needs pod compression over a model axis (ROADMAP Queue
A item 13f).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch

from .. import distributed as D
from ..configs import ARCHS, SHAPES, ArchConfig, ShapeConfig, get_arch, \
    shape_applicable
from ..models import model as Mdl
from ..models.sharding import default_rules, fsdp_rules, use_rules
from ..roofline.analysis import (HBM_BYTES, active_param_count,
                                 model_flops, roofline_from)
from ..roofline.walk import walk
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.train_step import TrainConfig, TrainState, train_step
from .mesh import make_production_mesh
from .shardings import (batch_specs, cache_specs, local_shape, param_specs,
                        state_specs, tree_map_with_path, zero3_gather,
                        zero3_param_specs)

__all__ = ["PARAM_DTYPE", "BF16_MOMENT_ARCHS", "ZERO3_ARCHS",
           "input_specs", "state_shapes", "cache_shapes", "make_step",
           "count_cell", "run_cell", "main"]

PARAM_DTYPE = torch.bfloat16
# bf16 moments for the 400B arch: fp32 moments do not fit a single v5e pod
# (the reference's choice, kept so that the cells count the same state)
BF16_MOMENT_ARCHS = {"llama4-maverick-400b-a17b"}
# ZeRO-3 (params sharded over model x data, gathered at use): 400B bf16
# params are 800 GB -- 16-way TP alone leaves 50 GB a rank resident
ZERO3_ARCHS = {"llama4-maverick-400b-a17b"}


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors for every model input of this (arch, shape) cell, whole
    (the global batch)."""
    b, s = shape.global_batch, shape.seq_len
    has_vision = cfg.frontend == "vision"
    n_text = s - cfg.n_patches if has_vision else s
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((b, n_text), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, n_text), torch.int32)
        if has_vision:
            specs["vision_embeds"] = _meta((b, cfg.n_patches, cfg.d_model),
                                           PARAM_DTYPE)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def state_shapes(cfg: ArchConfig, moment_dtype) -> TrainState:
    params = Mdl.init_params(cfg, device="meta", dtype=PARAM_DTYPE)
    return TrainState(params=params, opt=adamw_init(params, moment_dtype))


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 dtype=PARAM_DTYPE):
    return Mdl.init_caches(cfg, batch, max_len, dtype, "meta")


def _blocks(tree, specs, mesh):
    """Meta tensors of rank 0's block of each leaf of ``tree`` by
    ``specs`` (every rank's block has this shape)."""
    return tree_map_with_path(
        lambda path, leaf, sp: _meta(local_shape(tuple(leaf.shape), sp,
                                                 mesh), leaf.dtype),
        tree, specs)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _microbatches(shape: ShapeConfig, mesh, data_axes) -> int:
    """The reference's rule: cap ~16k tokens a rank a microbatch (bounds
    the fp32 logits / CE working set), dividing the local batch."""
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))
    tokens_per_dev = shape.global_batch * shape.seq_len // dsize
    local_batch = max(1, shape.global_batch // dsize)
    mb = max(1, min(tokens_per_dev // 16384, local_batch))
    while local_batch % mb:
        mb -= 1
    return mb


def make_step(cfg: ArchConfig, shape: ShapeConfig, mesh, data_axes,
              specs=None, microbatches: int | None = None,
              sharding_mode: str = "tp", ce_chunk: int = 0, gather=None):
    """Rank 0's step of the cell: ``step(state, batch)`` for a train shape
    (``specs`` the state's specs), ``step(params, caches, batch)`` for
    prefill (-> (logits, caches)) and decode (-> (next tokens, caches)),
    batch, state and caches rank 0's blocks (``gather``: the parameters'
    ZeRO-3 gather at use, ``shardings.zero3_gather``)."""
    data_axes = tuple(data_axes)
    if sharding_mode in ("fsdp", "dp"):
        # data_axes already includes "model" here (batch spans it)
        rules = fsdp_rules(data_axes=tuple(a for a in data_axes
                                           if a != "model"), mesh=mesh)
    else:
        rules = default_rules(data_axes=data_axes, mesh=mesh)
    if microbatches is None:
        microbatches = _microbatches(shape, mesh, data_axes)
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
                     remat=True, microbatches=microbatches,
                     ce_chunk=ce_chunk)

    if shape.kind == "train":
        def step(state, batch):
            with use_rules(rules):
                return train_step(cfg, tc, state, batch, mesh=mesh,
                                  data_axes=data_axes, specs=specs)
        return step

    if shape.kind == "prefill":
        def step(params, caches, batch):
            with use_rules(rules):
                logits, new_caches, _aux = Mdl.forward(
                    cfg, params, batch["tokens"], mode="prefill",
                    caches=caches, vision_embeds=batch.get("vision_embeds"),
                    mesh=mesh, data_axes=data_axes, max_len=shape.seq_len,
                    gather=gather)
            return logits, new_caches
        return step

    from .serve import greedy

    def step(params, caches, batch):   # decode / serve_step
        with use_rules(rules):
            logits, new_caches = Mdl.forward(
                cfg, params, batch["tokens"], mode="decode", caches=caches,
                pos=shape.seq_len - 1, mesh=mesh, data_axes=data_axes,
                max_len=shape.seq_len, gather=gather)
            tp, _ = Mdl.mesh_groups(mesh, data_axes)
            next_tok = greedy(cfg, params, logits, tp).to(torch.int32)
        return next_tok, new_caches
    return step


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, data_axes,
               sharding_mode: str = "tp", cache_dtype: str = "bf16",
               microbatches: int | None = None, pod_compress: bool = False,
               ce_chunk: int = 0, zero3: bool = False,
               moment_dtype=torch.float32) -> Dict[str, Any]:
    """Count rank 0's step of one cell on ``mesh`` (any ``launch.mesh.Mesh``
    with a ``model`` axis; ``data_axes`` its batch axes) and return the
    record's counted fields (the module docstring)."""
    data_axes = tuple(data_axes)
    if sharding_mode == "fsdp":
        raise NotImplementedError(
            "fsdp: the port's forward takes tensor-parallel blocks; a "
            "gather of model-sharded weights at use is not ported")
    batch_axes = (data_axes + ("model",)
                  if sharding_mode in ("fsdp", "dp") else data_axes)
    c_dtype = torch.float8_e4m3fn if cache_dtype == "fp8" else PARAM_DTYPE
    record: Dict[str, Any] = {"zero3": True} if zero3 else {}

    t0 = time.time()
    specs_in = input_specs(cfg, shape)
    b_local = _blocks(specs_in, batch_specs(specs_in, mesh, batch_axes), mesh)

    if shape.kind == "train":
        st_shapes = state_shapes(cfg, moment_dtype)
        # ZeRO axes: in dp/fsdp regimes the moments shard over data+model
        zero_axes = batch_axes if sharding_mode in ("dp", "fsdp") \
            else data_axes
        st_specs = state_specs(st_shapes, mesh, zero_axes, zero=True,
                               mode=sharding_mode, zero3=zero3)
        if pod_compress and "pod" in mesh.shape:
            from ..train.pod_compress import pod_compressed_train_step

            mb = _microbatches(shape, mesh, data_axes) \
                if microbatches is None else microbatches
            tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4,
                                                   weight_decay=0.1),
                             remat=True, microbatches=mb)
            # the port's pod-compressed step updates whole moments on
            # every rank (no ZeRO)
            st_specs = state_specs(st_shapes, mesh, ("data",), zero=False,
                                   mode=sharding_mode)
            rules = default_rules(data_axes=("data",), mesh=mesh)
            record["pod_compress"] = True
            with D.planned(mesh.size, 0):
                inner = pod_compressed_train_step(
                    cfg, tc, mesh, pod_axis="pod", inner_data_axes=("data",))

            def step(state, batch):
                with use_rules(rules):
                    return inner(state, batch)
        else:
            step = make_step(cfg, shape, mesh, batch_axes, specs=st_specs,
                             sharding_mode=sharding_mode,
                             microbatches=microbatches, ce_chunk=ce_chunk)
        args = (_blocks(st_shapes, st_specs, mesh), b_local)
        n_tokens = shape.global_batch * shape.seq_len
        params_shapes = st_shapes.params
    else:
        params_shapes = Mdl.init_params(cfg, device="meta", dtype=PARAM_DTYPE)
        p_specs = zero3_param_specs(params_shapes, mesh, data_axes) \
            if zero3 else param_specs(params_shapes, mesh, mode=sharding_mode)
        c_shapes = cache_shapes(cfg, shape.global_batch, shape.seq_len,
                                c_dtype)
        c_specs = cache_specs(c_shapes, mesh, shape.global_batch,
                              batch_axes)
        step = make_step(cfg, shape, mesh, batch_axes,
                         sharding_mode=sharding_mode,
                         gather=zero3_gather(p_specs, mesh, data_axes))
        args = (_blocks(params_shapes, p_specs, mesh),
                _blocks(c_shapes, c_specs, mesh), b_local)
        n_tokens = shape.global_batch * (shape.seq_len
                                         if shape.kind == "prefill" else 1)

    with D.planned(mesh.size, 0):
        wk = walk(step, *args)
    del args
    count_s = time.time() - t0

    roof = roofline_from(wk, dtype=PARAM_DTYPE)
    n_active = active_param_count(cfg, params_shapes)
    n_total = Mdl.param_count(params_shapes)
    mf = model_flops(cfg, n_tokens, n_active)
    if shape.kind != "train":
        mf /= 3.0               # forward only: 2ND

    n_chips = mesh.size
    peak = wk.peak_live_bytes
    record.update(
        status="ok",
        n_chips=n_chips,
        count_s=round(count_s, 2),
        memory={
            "argument_bytes": wk.argument_bytes,
            "output_bytes": wk.output_bytes,
            "temp_bytes": peak - wk.argument_bytes,
            "alias_bytes": wk.alias_bytes,
            "peak_bytes": peak,
            "hbm_per_device_bytes": peak,
            "fits_80gb": bool(peak < HBM_BYTES),
        },
        roofline={
            "flops": roof.flops,
            "hbm_bytes": roof.hbm_bytes,
            "collective_bytes": roof.collective_bytes,
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant,
            "by_op": roof.by_op,
            "n_collectives": roof.n_collectives,
            "dot_flops": wk.dot_flops,
            "by_kernel": wk.by_kernel,
        },
        model_flops_global=mf,
        counted_flops_global=roof.flops * n_chips,
        useful_flops_ratio=(mf / (roof.flops * n_chips)
                            if roof.flops else None),
        n_params_total=n_total,
        n_params_active=n_active,
        moment_dtype=str(moment_dtype).replace("torch.", ""),
    )
    return record


def run_cell(arch, shape_name, mesh_kind: str,
             dgro_order: bool = False, sharding_mode: str = "tp",
             cache_dtype: str = "bf16",
             microbatches: int | None = None,
             pod_compress: bool = False,
             ce_chunk: int = 0) -> Dict[str, Any]:
    """One cell's record: ``arch`` a config's name (or an ``ArchConfig``),
    ``shape_name`` one of ``SHAPES`` (or a ``ShapeConfig``), ``mesh_kind``
    "single" or "multi" (the production mesh)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = shape_applicable(cfg, shape)
    record: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
        "timestamp": time.time(), "sharding_mode": sharding_mode,
        "cache_dtype": cache_dtype,
    }
    if not ok:
        record.update(status="skipped", reason=why)
        return record
    if sharding_mode in ("fsdp", "dp") and cfg.n_experts:
        record.update(status="error",
                      error="fsdp mode not wired for shard_map EP archs")
        return record

    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi, dgro_order=dgro_order)
    record.update(count_cell(
        cfg, shape, mesh, ("pod", "data") if multi else ("data",),
        sharding_mode=sharding_mode, cache_dtype=cache_dtype,
        microbatches=microbatches, pod_compress=pod_compress and multi,
        ce_chunk=ce_chunk, zero3=cfg.name in ZERO3_ARCHS,
        moment_dtype=(torch.bfloat16 if cfg.name in BF16_MOMENT_ARCHS
                      else torch.float32)))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--dgro-order", action="store_true",
                    help="DGRO-optimized device order for the DCN axes")
    ap.add_argument("--force", action="store_true",
                    help="re-run existing cells")
    ap.add_argument("--sharding", default="tp", choices=["tp", "fsdp", "dp"],
                    help="parallelism regime")
    ap.add_argument("--cache-dtype", default="bf16", choices=["bf16", "fp8"],
                    help="KV-cache dtype")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="chunked cross-entropy block size (0=dense)")
    ap.add_argument("--pod-compress", action="store_true",
                    help="int8 ring gradient reduce over the pod axis "
                         "(multi mesh only)")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip existing] {tag}")
                    continue
                print(f"[run] {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_kind, args.dgro_order,
                                   sharding_mode=args.sharding,
                                   cache_dtype=args.cache_dtype,
                                   microbatches=args.microbatches,
                                   pod_compress=args.pod_compress,
                                   ce_chunk=args.ce_chunk)
                except Exception as e:  # noqa: BLE001 - sweep must continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                    print(f"  ERROR: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                if rec.get("status") == "ok":
                    r = rec["roofline"]
                    print(f"  ok chips={rec['n_chips']} count={rec['count_s']}"
                          f"s hbm/dev="
                          f"{rec['memory']['hbm_per_device_bytes'] / 1e9:.2f}"
                          f"GB terms(c/m/coll)={r['compute_s']:.4f}/"
                          f"{r['memory_s']:.4f}/{r['collective_s']:.4f}s "
                          f"dom={r['dominant']}", flush=True)
    print(f"done; {failures} failures")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
