"""Batched topology evaluation — the bulk diameter/APSP engine (torch port).

Everything DGRO measures reduces to "score many candidate overlays by
diameter".  This module turns that into memory-bounded device calls.

* graph assembly (host, numpy) — ``rings_to_edges`` /
  ``adjacency_batch_from_edges`` / ``adjacency_batch_from_rings`` build
  (B, N, N) arrays with vectorized scatters; ``overlay_with_rings`` fuses a
  base overlay with B candidate rings; ``pad_adjacency_blocks`` pads
  variable-size blocks; :class:`RingBlockSource` hands the streaming facade
  one chunk of dense matrices at a time.
* device compute — ``batched_apsp`` / ``batched_diameter`` on a (B, N, N)
  tensor.  Three interchangeable methods: ``"fw"`` (vectorized
  Floyd-Warshall in plain torch, the CPU default), ``"squaring"`` (min-plus
  squaring; each step is the CUDA kernel K1 on the card) and ``"tiled"``
  (blocked Floyd-Warshall, ``kernels.minplus.ops.apsp_tiled``: K2 + K1).
  On CUDA the default is ``squaring`` below ``REPRO_APSP_TILED_N`` (512)
  nodes and ``tiled`` from there on, so the main path runs the kernels.
* host facade — ``diameters`` / ``apsp_matrices`` / ``diameters_of_rings``
  STREAM the batch through fixed-size chunks (``default_chunk`` sizes them
  from the per-method memory model): peak device footprint is one chunk.
  Reduced precision (``dtype="bfloat16"`` or ``"int16"``) measures its own
  error on float32 probes and re-runs exactly past ``exact_rtol``.
  ``eval_options`` scopes any knob -- including ``device`` -- over a call
  tree; ``last_eval_report()`` returns the facts of the last call.
* sharded compute over the ranks of a ``launch.mesh.Mesh`` axis
  (``torch.distributed``, collectives in ``repro_torch.distributed``) --
  ``diameters_sharded`` scores a contiguous sub-batch on each rank with
  the streaming ``diameters`` and gathers the scores;
  ``apsp_rowshard`` squares one (N, N) matrix by (N/k, N) row blocks,
  gathering the blocks once a squaring (``ops.minplus``: K1 with a batch
  of one on the card).  Every rank calls them and gets the whole result;
  on an axis of one rank, or with no process group, they are the
  one-device facade (the reference's own fallback).

Instrumentation is the reference's (``repro_torch.obs``): every device
call lands in ``repro_apsp_seconds{method, phase}`` (first call per key
vs steady state, via ``obs.jit_phase``; the span ends on the result's
``.cpu()``, a real sync) and sets ``repro_apsp_workingset_bytes``;
reduced-precision evals record their measured error and
``repro_apsp_exact_fallbacks_total``.

The device follows ``repro_torch.device``: CUDA unless the caller asks for
the CPU (``device=`` here, or ``eval_options(device="cpu")``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.device import resolve_device
from repro_torch.kernels.minplus import ops as minplus_ops
from repro_torch.obs import REGISTRY, jit_phase, jit_span
from repro_torch.obs.tracing import SPAN_BUCKETS_S

from .diameter import INF, apsp, is_edge, largest_cc_diameter

__all__ = [
    "rings_to_edges",
    "adjacency_batch_from_edges",
    "adjacency_batch_from_rings",
    "overlay_with_rings",
    "pad_adjacency_blocks",
    "RingBlockSource",
    "batched_apsp",
    "batched_diameter",
    "diameters",
    "diameters_of_rings",
    "diameters_sharded",
    "apsp_matrices",
    "apsp_rowshard",
    "quantize_latency",
    "eval_options",
    "last_eval_report",
    "default_chunk",
    "workingset_bytes",
]

METHODS = ("fw", "squaring", "tiled")
DTYPES = ("float32", "bfloat16", "int16")
DEFAULT_BUDGET_BYTES = 1 << 28          # ~256 MiB of device temporaries
DEFAULT_TILED_N = 512                   # CUDA auto-switch to the tiled path
DEFAULT_EXACT_RTOL = 0.05               # quantized-eval fallback threshold
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_APSP_SECONDS = REGISTRY.histogram(
    "repro_apsp_seconds",
    "device wall time per APSP/diameter engine call, compile/execute split",
    labels=("method", "phase"), buckets=SPAN_BUCKETS_S)
_APSP_WORKINGSET = REGISTRY.gauge(
    "repro_apsp_workingset_bytes",
    "modeled peak device working set of the last engine call")
_APSP_QUANT_ERR = REGISTRY.gauge(
    "repro_apsp_quant_rel_err",
    "measured relative diameter error of the last reduced-precision eval")
_APSP_FALLBACKS = REGISTRY.counter(
    "repro_apsp_exact_fallbacks_total",
    "reduced-precision evals that exceeded exact_rtol and re-ran in float32")


# ---------------------------------------------------------------------------
# graph assembly (host, vectorized)
# ---------------------------------------------------------------------------

def rings_to_edges(genomes) -> np.ndarray:
    """``(B, K, N)`` ring permutations -> ``(B, K*N, 2)`` edge lists.

    Accepts a (B, K, N) array, a (B, N) array (K=1), or a nested list of
    per-genome ring permutations.
    """
    g = np.asarray(genomes, dtype=np.intp)
    if g.ndim == 2:
        g = g[:, None, :]
    assert g.ndim == 3, g.shape
    nxt = np.roll(g, -1, axis=-1)
    return np.stack([g, nxt], axis=-1).reshape(g.shape[0], -1, 2)


def adjacency_batch_from_edges(w: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(B, E, 2) edge lists -> (B, N, N) float32 adjacencies with INF on
    non-edges and 0 diagonal; parallel edges keep the min weight."""
    w = np.asarray(w)
    n = w.shape[0]
    e = np.asarray(edges, dtype=np.intp)
    assert e.ndim == 3 and e.shape[-1] == 2, e.shape
    b = e.shape[0]
    d = np.full((b, n, n), float(INF), dtype=np.float32)
    d[:, np.arange(n), np.arange(n)] = 0.0
    if e.shape[1]:
        bi = np.broadcast_to(np.arange(b)[:, None], e.shape[:2])
        u, v = e[..., 0], e[..., 1]
        np.minimum.at(d, (bi, u, v), w[u, v].astype(np.float32))
        np.minimum.at(d, (bi, v, u), w[v, u].astype(np.float32))
    return d


def adjacency_batch_from_rings(w: np.ndarray, genomes) -> np.ndarray:
    """(B, K, N) ring permutations -> (B, N, N) union-of-rings adjacencies."""
    return adjacency_batch_from_edges(w, rings_to_edges(genomes))


def overlay_with_rings(adj: np.ndarray, w: np.ndarray, rings) -> np.ndarray:
    """B candidate overlays: the base ``adj`` each augmented with one ring."""
    cand = adjacency_batch_from_rings(w, rings)
    return np.minimum(np.asarray(adj, np.float32)[None], cand)


def pad_adjacency_blocks(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Pad variable-size adjacencies to one (B, N_max, N_max) batch; padded
    nodes are isolated singletons, so each block keeps its own diameter."""
    blocks = [np.asarray(b, np.float32) for b in blocks]
    n_max = max(b.shape[0] for b in blocks)
    out = np.full((len(blocks), n_max, n_max), float(INF), dtype=np.float32)
    out[:, np.arange(n_max), np.arange(n_max)] = 0.0
    for i, b in enumerate(blocks):
        out[i, :b.shape[0], :b.shape[0]] = b
    return out


class RingBlockSource:
    """Lazy adjacency source: assembles (chunk, N, N) blocks on demand, so
    ``diameters_of_rings`` holds at most ONE chunk of dense matrices on the
    host.  The facade accepts any object with ``__len__``, ``.n`` and
    ``.block(lo, hi)``."""

    def __init__(self, w: np.ndarray, genomes):
        self.w = np.asarray(w)
        g = np.asarray(genomes, dtype=np.intp)
        if g.ndim == 2:
            g = g[:, None, :]
        assert g.ndim == 3, g.shape
        self.genomes = g

    def __len__(self) -> int:
        return self.genomes.shape[0]

    @property
    def n(self) -> int:
        return self.w.shape[0]

    def block(self, lo: int, hi: int) -> np.ndarray:
        return adjacency_batch_from_rings(self.w, self.genomes[lo:hi])


class _ArraySource:
    """Adapter giving an eager (B, N, N) array the block-source protocol."""

    def __init__(self, adjs: np.ndarray):
        adjs = np.asarray(adjs, dtype=np.float32)
        assert adjs.ndim == 3 and adjs.shape[1] == adjs.shape[2], adjs.shape
        self.adjs = adjs

    def __len__(self) -> int:
        return self.adjs.shape[0]

    @property
    def n(self) -> int:
        return self.adjs.shape[-1]

    def block(self, lo: int, hi: int) -> np.ndarray:
        return self.adjs[lo:hi]


def _as_source(adjs):
    if hasattr(adjs, "block") and hasattr(adjs, "n"):
        return adjs
    return _ArraySource(adjs)


class _RowSource:
    """Rows ``rows`` of another block source (repeats allowed), fetching
    each run of consecutive rows in one ``block`` call."""

    def __init__(self, src, rows):
        self.src = src
        self.rows = np.asarray(rows, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def n(self) -> int:
        return self.src.n

    def block(self, lo: int, hi: int) -> np.ndarray:
        rows = self.rows[lo:hi]
        cuts = np.flatnonzero(np.diff(rows) != 1) + 1
        runs = [np.asarray(self.src.block(int(r[0]), int(r[-1]) + 1),
                           np.float32)
                for r in np.split(rows, cuts)]
        return runs[0] if len(runs) == 1 else np.concatenate(runs)


# ---------------------------------------------------------------------------
# scoped evaluation options
# ---------------------------------------------------------------------------

_OPT_KEYS = frozenset({"method", "dtype", "chunk", "tile", "use_kernel",
                       "budget_bytes", "exact_rtol", "device"})
_OPT_ENV = {
    "method": "REPRO_APSP_METHOD",
    "dtype": "REPRO_APSP_DTYPE",
    "chunk": "REPRO_APSP_CHUNK",
    "tile": "REPRO_APSP_TILE",
    "budget_bytes": "REPRO_APSP_MEM_BYTES",
    "exact_rtol": "REPRO_APSP_RTOL",
}
_OPT_PARSE = {"chunk": int, "tile": int, "budget_bytes": int,
              "exact_rtol": float}

_ctx = threading.local()


@contextlib.contextmanager
def eval_options(**opts):
    """Scope engine knobs over a call tree without threading kwargs.

    ``with eval_options(device="cpu", method="tiled"): ...`` makes every
    facade call inside the block (including ones buried in
    ``selection.adapt`` or an overlay builder) pick up the options.
    Precedence: explicit call-site kwarg > innermost ``eval_options`` >
    ``REPRO_APSP_*`` env var > built-in default.  Keys: method, dtype,
    chunk, tile, use_kernel, budget_bytes, exact_rtol, device.
    """
    unknown = set(opts) - _OPT_KEYS
    if unknown:
        raise ValueError(f"unknown eval options {sorted(unknown)}; "
                         f"known: {sorted(_OPT_KEYS)}")
    if opts.get("method") is not None and opts["method"] not in METHODS:
        raise ValueError(f"unknown method {opts['method']!r}; "
                         f"options {METHODS}")
    if opts.get("dtype") is not None and opts["dtype"] not in DTYPES:
        raise ValueError(f"unknown dtype {opts['dtype']!r}; options {DTYPES}")
    if opts.get("device") is not None:
        resolve_device(opts["device"])
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append(dict(opts))
    try:
        yield
    finally:
        stack.pop()


def _opt(name: str, explicit=None):
    """Resolve one option: explicit > context > env > None."""
    if explicit is not None:
        return explicit
    for frame in reversed(getattr(_ctx, "stack", []) or []):
        if frame.get(name) is not None:
            return frame[name]
    env = _OPT_ENV.get(name)
    if env and env in os.environ:
        return _OPT_PARSE.get(name, str)(os.environ[env])
    return None


def eval_device(device=None) -> torch.device:
    """The device a facade call runs on: explicit > ``eval_options`` >
    ``repro_torch.device`` default (CUDA, raising where there is none)."""
    return resolve_device(_opt("device", device))


_report = threading.local()


def last_eval_report() -> dict:
    """Facts about this thread's most recent facade call: resolved device /
    method / dtype / chunk / tile, modeled working-set bytes, device call
    count, measured quantization error and whether the exact fallback
    fired."""
    return dict(getattr(_report, "data", {}))


# ---------------------------------------------------------------------------
# device compute (one call per chunk)
# ---------------------------------------------------------------------------

def _auto_method(use_kernel: bool, n: Optional[int], device: torch.device,
                 tiled_n: int = DEFAULT_TILED_N) -> str:
    """Device- and size-aware default: CUDA runs min-plus squaring (K1)
    until the blocked Floyd-Warshall (K2 + K1) takes over at ``tiled_n``
    nodes -- the JAX package's accelerator rule, not yet re-set from H100
    timings; the CPU runs vectorized FW, or squaring when the kernel path
    is asked for, as the reference does."""
    if device.type == "cuda":
        if n is not None and n >= tiled_n:
            return "tiled"
        return "squaring"
    return "squaring" if use_kernel else "fw"


def batched_apsp(adjs: torch.Tensor, *, use_kernel: bool = False,
                 method: str | None = None, symmetric: bool = True,
                 dtype: str = "float32",
                 tile: int | None = None) -> torch.Tensor:
    """All-pairs shortest paths for a (B, N, N) stack, on its device.

    * ``"fw"`` — batched vectorized Floyd-Warshall in plain torch, O(N^3)
      with a (B, N, N) temporary per step; the CPU default.
    * ``"squaring"`` — ceil(log2(N-1)) batched min-plus squarings
      (``kernels.minplus.ops.minplus_batched``: K1 on CUDA, the dense twin
      on the CPU); the CUDA default below ``DEFAULT_TILED_N`` nodes and
      the CPU method under ``use_kernel``.
    * ``"tiled"`` — blocked Floyd-Warshall (``ops.apsp_tiled``: K2 + K1 on
      CUDA), one matrix at a time; the CUDA default from
      ``DEFAULT_TILED_N`` nodes on.

    ``symmetric`` (default) lets FW read only the contiguous row slice and
    the tiled method derive its column panel from the row panel — valid for
    the undirected overlays every builder produces.  ``dtype`` selects the
    compute precision (``"float32"``/``"bfloat16"``); the result keeps it.
    """
    if method is None:
        method = _auto_method(use_kernel, adjs.shape[-1], adjs.device)
    assert method in METHODS, method
    assert dtype in _TORCH_DTYPES, dtype
    d = adjs.to(_TORCH_DTYPES[dtype])
    n = d.shape[-1]
    if method == "fw":
        for k in range(n):
            row = d[:, k, :]
            col = row if symmetric else d[:, :, k]
            d = torch.minimum(d, col[:, :, None] + row[:, None, :])
        return d
    if method == "tiled":
        return torch.stack([minplus_ops.apsp_tiled(m, tile=tile,
                                                   symmetric=symmetric)
                            for m in d])
    n_iters = max(1, int(np.ceil(np.log2(max(n - 1, 2)))))
    for _ in range(n_iters):
        d = minplus_ops.minplus_batched(d, d)
    return d


def batched_diameter(adjs: torch.Tensor, *, use_kernel: bool = False,
                     method: str | None = None, symmetric: bool = True,
                     dtype: str = "float32",
                     tile: int | None = None) -> torch.Tensor:
    """(B, N, N) adjacencies -> (B,) float32 largest-CC diameters."""
    d = batched_apsp(adjs, use_kernel=use_kernel, method=method,
                     symmetric=symmetric, dtype=dtype, tile=tile)
    return largest_cc_diameter(d)


# ---------------------------------------------------------------------------
# memory model
# ---------------------------------------------------------------------------

def workingset_bytes(chunk: int, n: int, method: str = "fw", *,
                     dtype: str = "float32", tile: int | None = None,
                     use_kernel: bool = False) -> int:
    """Modeled peak device working set of one engine call, per method —
    the JAX package's model, with ``use_kernel`` meaning "the kernel runs"
    (callers pass True on CUDA); not yet re-derived for torch temporaries.

    * ``fw`` and kernel ``squaring``: 8 N^2 slabs per batch item.
    * plain ``squaring`` (the CPU twin): the dense (chunk, N, N, N)
      broadcast-min temporary.
    * ``tiled``: the (chunk, N, N) stack plus ONE matrix in flight — two
      padded copies and three (tile, N) panels.
    """
    item = 2 if dtype == "bfloat16" else 4
    if method == "squaring" and not use_kernel:
        return item * chunk * n ** 3
    if method == "tiled":
        t = tile or minplus_ops.default_tile(n)
        npad = -(-n // t) * t
        return item * (chunk * n * n + 2 * npad * npad + 3 * t * npad)
    return item * chunk * n * n * 8


def default_chunk(n: int, method: str = "fw",
                  budget_bytes: int | None = None, *,
                  dtype: str = "float32", tile: int | None = None,
                  use_kernel: bool = False) -> int:
    """Largest batch chunk whose modeled working set stays under the
    budget (``REPRO_APSP_MEM_BYTES`` when set, else 256 MiB); always >= 1."""
    if budget_bytes is None:
        budget_bytes = _opt("budget_bytes") or DEFAULT_BUDGET_BYTES
    one = workingset_bytes(1, n, method, dtype=dtype, tile=tile,
                           use_kernel=use_kernel)
    fixed = 0
    if method == "tiled":
        # panels + padded copies are shared across the chunk, not per-item
        item = 2 if dtype == "bfloat16" else 4
        fixed = one - item * n * n
        one = item * n * n
    return max(1, (budget_bytes - fixed) // max(1, one))


def quantize_latency(adjs: np.ndarray, bits: int = 16):
    """Quantize finite latencies to a uniform ``2**bits - 1``-level grid.

    Only ``is_edge`` entries move: the 0 diagonal and the 1e9 INF sentinel
    pass through BIT-EXACT.  Returns ``(quantized, scale)``; a shortest
    path of H hops is off by at most ``H * scale / 2``.
    """
    a = np.asarray(adjs, np.float32)
    mask = np.asarray(is_edge(a))
    if not mask.any():
        return a.copy(), 0.0
    levels = (1 << bits) - 1
    scale = float(a[mask].max()) / levels
    q = np.where(mask, np.rint(a / max(scale, 1e-30)) * scale, a)
    return q.astype(np.float32), scale


# ---------------------------------------------------------------------------
# host facade (streaming)
# ---------------------------------------------------------------------------

class _Plan:
    """The resolved knobs of one facade call."""

    def __init__(self, n: int, *, use_kernel, method, dtype, tile, chunk,
                 device, b: int):
        self.device = eval_device(device)
        self.use_kernel = bool(use_kernel or _opt("use_kernel"))
        method = _opt("method", method)
        if method is None:
            method = _auto_method(
                self.use_kernel, n, self.device,
                int(os.environ.get("REPRO_APSP_TILED_N", DEFAULT_TILED_N)))
        assert method in METHODS, method
        self.method = method
        self.dtype = _opt("dtype", dtype) or "float32"
        assert self.dtype in DTYPES, self.dtype
        self.tile = _opt("tile", tile)
        self.compute_dtype = ("bfloat16" if self.dtype == "bfloat16"
                              else "float32")
        kernel = self.use_kernel or self.device.type == "cuda"
        self.chunk = _opt("chunk", chunk) or default_chunk(
            n, method, dtype=self.dtype, tile=self.tile, use_kernel=kernel)
        self.ws = workingset_bytes(min(b, self.chunk), n, method,
                                   dtype=self.compute_dtype, tile=self.tile,
                                   use_kernel=kernel)

    def report(self, b: int, n: int, calls: int, max_scale: float) -> dict:
        return {"b": b, "n": n, "device": str(self.device),
                "method": self.method, "dtype": self.dtype,
                "chunk": self.chunk, "tile": self.tile,
                "workingset_bytes": self.ws, "device_calls": calls,
                "quant_scale": max_scale, "quant_rel_err": 0.0,
                "fallback": False}


def _observe_call(method: str, key, seconds: float, ws_bytes: int) -> None:
    if not REGISTRY.enabled:
        return
    _APSP_SECONDS.labels(method=method,
                         phase=jit_phase("batcheval.apsp", key)).observe(
        seconds)
    _APSP_WORKINGSET.set(ws_bytes)


def _stream(src, b: int, fn, plan: "_Plan", *, compute_dtype: str,
            quantize: bool, symmetric: bool):
    """Drive ``fn`` over fixed-size chunks of ``src``, never holding more
    than one (chunk, N, N) block on host or device.  The trailing partial
    chunk is padded by repeating its first matrix so every device call has
    the same shape; a batch of at most one chunk runs unpadded in one
    call.  Each call is timed from the upload to the result's ``.cpu()``
    into ``repro_apsp_seconds``, keyed as the reference keys it."""
    outs = []
    calls = 0
    max_scale = 0.0
    chunk = plan.chunk
    single = b <= chunk
    for lo in range(0, b, chunk):
        hi = min(b, lo + chunk)
        blk = np.asarray(src.block(lo, hi), np.float32)
        if quantize:
            blk, scale = quantize_latency(blk)
            max_scale = max(max_scale, scale)
        if not single and hi - lo < chunk:
            blk = np.concatenate(
                [blk, np.repeat(blk[:1], chunk - (hi - lo), axis=0)], axis=0)
        t0 = time.perf_counter()
        res = fn(torch.from_numpy(blk).to(plan.device)).cpu().numpy()
        _observe_call(plan.method,
                      (blk.shape[0], blk.shape[-1], plan.use_kernel,
                       plan.method, symmetric, compute_dtype, plan.tile),
                      time.perf_counter() - t0, plan.ws)
        outs.append(res[:hi - lo])
        calls += 1
    return outs, calls, max_scale


def diameters(adjs, *, use_kernel: bool = False, method: str | None = None,
              symmetric: bool = True, chunk: int | None = None,
              dtype: str | None = None, tile: int | None = None,
              exact_rtol: float | None = None, device=None) -> np.ndarray:
    """Diameters for a batch of adjacencies, as a host (B,) float32 array.

    ``adjs`` is a (B, N, N) array or any lazy block source (``__len__``,
    ``.n``, ``.block(lo, hi)`` — e.g. :class:`RingBlockSource`).  The batch
    is STREAMED through fixed-size device chunks.

    ``dtype`` picks the evaluation precision: ``"float32"`` (exact),
    ``"bfloat16"``, or ``"int16"`` (latencies quantized to a 16-bit grid,
    evaluated in f32).  Reduced-precision runs re-score a probe subset in
    float32 and, past ``exact_rtol`` (default 0.05), re-run the whole batch
    in float32.  All knobs resolve through ``eval_options`` /
    ``REPRO_APSP_*`` env vars; ``device`` through ``eval_options`` and the
    ``repro_torch.device`` rule.
    """
    src = _as_source(adjs)
    b, n = len(src), src.n
    if b == 0:
        return np.zeros((0,), np.float32)
    plan = _Plan(n, use_kernel=use_kernel, method=method, dtype=dtype,
                 tile=tile, chunk=chunk, device=device, b=b)
    rtol = _opt("exact_rtol", exact_rtol)
    if rtol is None and plan.dtype != "float32":
        rtol = DEFAULT_EXACT_RTOL

    def run(cdt: str, quant: bool):
        def fn(blk):
            return batched_diameter(blk, use_kernel=plan.use_kernel,
                                    method=plan.method, symmetric=symmetric,
                                    dtype=cdt, tile=plan.tile)
        return _stream(src, b, fn, plan, compute_dtype=cdt, quantize=quant,
                       symmetric=symmetric)

    if b <= plan.chunk:
        # the reference's one-shot span over a batch of at most one chunk
        with jit_span("batcheval.diameters",
                      key=(b, n, plan.use_kernel, plan.method, symmetric,
                           plan.dtype)):
            outs, calls, max_scale = run(plan.compute_dtype,
                                         plan.dtype == "int16")
    else:
        outs, calls, max_scale = run(plan.compute_dtype,
                                     plan.dtype == "int16")
    out = np.concatenate(outs) if len(outs) > 1 else outs[0]

    rep = plan.report(b, n, calls, max_scale)
    if plan.dtype != "float32":
        rel, out, fellback = _verify_quantized(src, b, out, rtol, run,
                                               plan.device)
        rep["quant_rel_err"], rep["fallback"] = rel, fellback
        if fellback:
            rep["dtype"] = "float32"
    _report.data = rep
    return out


def _verify_quantized(src, b: int, out: np.ndarray, rtol: Optional[float],
                      run, device: torch.device) -> tuple:
    """Measure reduced-precision error on float32 probes; past ``rtol``,
    re-run the whole batch exactly (the exactness-fallback contract)."""
    probes = np.arange(0, b, max(1, b // 8))[:8]
    ref = np.concatenate([
        batched_diameter(torch.from_numpy(np.asarray(
            src.block(int(i), int(i) + 1), np.float32)).to(device))
        .cpu().numpy()
        for i in probes])
    denom = np.maximum(np.abs(ref), 1e-6)
    rel = float(np.max(np.abs(out[probes] - ref) / denom)) if len(ref) else 0.0
    if REGISTRY.enabled:
        _APSP_QUANT_ERR.set(rel)
    if rtol is not None and rel > rtol:
        _APSP_FALLBACKS.inc()
        outs, _, _ = run("float32", False)
        out = np.concatenate(outs) if len(outs) > 1 else outs[0]
    return rel, out, bool(rtol is not None and rel > rtol)


def apsp_matrices(adjs, *, use_kernel: bool = False,
                  method: str | None = None, symmetric: bool = True,
                  chunk: int | None = None, dtype: str | None = None,
                  tile: int | None = None, device=None) -> np.ndarray:
    """Full (B, N, N) float32 APSP distance matrices, streamed per chunk;
    the result is re-widened to float32 on the host.  No probe
    verification — reduced precision is the caller's explicit contract for
    distances."""
    src = _as_source(adjs)
    b, n = len(src), src.n
    if b == 0:
        return np.zeros((0, n, n), np.float32)
    plan = _Plan(n, use_kernel=use_kernel, method=method, dtype=dtype,
                 tile=tile, chunk=chunk, device=device, b=b)

    def fn(blk):
        return batched_apsp(blk, use_kernel=plan.use_kernel,
                            method=plan.method, symmetric=symmetric,
                            dtype=plan.compute_dtype, tile=plan.tile).float()

    outs, calls, max_scale = _stream(src, b, fn, plan,
                                     compute_dtype=plan.compute_dtype,
                                     quantize=plan.dtype == "int16",
                                     symmetric=symmetric)
    _report.data = plan.report(b, n, calls, max_scale)
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


def diameters_of_rings(w: np.ndarray, genomes, *, use_kernel: bool = False,
                       method: str | None = None,
                       chunk: int | None = None,
                       dtype: str | None = None, device=None) -> np.ndarray:
    """Score B K-ring genomes by overlay diameter, streaming the adjacency
    assembly chunk-by-chunk (never a dense (B, N, N) host tensor)."""
    return diameters(RingBlockSource(w, genomes), use_kernel=use_kernel,
                     method=method, chunk=chunk, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# sharded compute (multi-device)
# ---------------------------------------------------------------------------

# the default meshes, one per (axis, world size), each beside the world's
# process group it was made under: a mesh caches its groups, and
# ``new_group`` is a collective whose gloo groups are never freed, so the
# default mesh's groups are made once a process, not once a call
_EVAL_MESHES: dict = {}


def _axis_mesh(mesh, axis: str):
    """``mesh`` or, where it is None, ``launch.mesh.make_eval_mesh`` over
    the process group's world (one rank without a group), as the reference
    builds one over every local device; the default is made once for each
    axis and world (:data:`_EVAL_MESHES`)."""
    if mesh is None:
        from repro_torch.launch.mesh import make_eval_mesh

        pg = distributed.world().pg
        key = (axis, distributed.world_size())
        hit = _EVAL_MESHES.get(key)
        if hit is None or hit[0] is not pg:
            hit = _EVAL_MESHES[key] = (pg, make_eval_mesh(axis=axis))
        mesh = hit[1]
    return mesh, int(mesh.shape[axis])


def diameters_sharded(adjs, *, mesh=None, axis: str = "batch",
                      use_kernel: bool = False, method: str | None = None,
                      symmetric: bool = True, dtype: str | None = None,
                      tile: int | None = None, device=None) -> np.ndarray:
    """``diameters`` with the batch axis sharded over the ranks of a mesh
    axis (``repro_torch.launch.mesh.Mesh``); every rank of the mesh calls
    it with the same ``adjs`` -- a (B, N, N) array or, as ``diameters``
    takes, a lazy block source such as :class:`RingBlockSource` -- and gets
    the whole (B,) result.

    As the reference does, B is padded to a multiple of the axis size k by
    repeating ``adjs[:1]`` (and ``dtype="int16"`` quantizes the whole batch
    on one grid first); rank i scores its contiguous sub-batch with the
    streaming ``diameters`` on its device (K1 / K2 on the card), and the
    scores are ``all_gather``ed over the axis's group and the pad dropped.
    With no mesh, a 1-D ``make_eval_mesh`` over the world; with an axis of
    one rank (or no process group) this is the streaming ``diameters``, the
    reference's own single-device fallback.  ``device`` follows the
    ``repro_torch.device`` rule."""
    src = _as_source(adjs)
    b, n = len(src), src.n
    if b == 0:
        return np.zeros((0,), np.float32)
    mesh, k = _axis_mesh(mesh, axis)
    if k <= 1:
        return diameters(src, use_kernel=use_kernel, method=method,
                         symmetric=symmetric, dtype=dtype, tile=tile,
                         device=device)
    group = mesh.group(axis)
    if (_opt("dtype", dtype) or "float32") == "int16":
        if not isinstance(src, _ArraySource):
            raise ValueError("dtype='int16' over a mesh quantizes the whole "
                             "batch on one grid: pass it as an array")
        # one grid for the whole batch, as the reference quantizes it
        src, dtype = _ArraySource(quantize_latency(src.adjs)[0]), "float32"
    per = -(-b // k)
    rows = np.arange(group.index * per, (group.index + 1) * per)
    rows[rows >= b] = 0                  # the pad repeats adjs[:1]
    t0 = time.perf_counter()
    local = diameters(_RowSource(src, rows), use_kernel=use_kernel,
                      method=method, symmetric=symmetric, dtype=dtype,
                      tile=tile, device=device)
    rep = last_eval_report()
    dev = eval_device(device)
    out = distributed.all_gather(torch.from_numpy(local).to(dev),
                                 group).cpu().numpy()
    _observe_call(rep["method"], ("sharded", k, per, n, rep["method"],
                                  symmetric, rep["dtype"], rep["tile"]),
                  time.perf_counter() - t0, rep["workingset_bytes"])
    rep.update(b=b, devices=k, chunk=per)
    _report.data = rep
    return out[:b]


def apsp_rowshard(adj: np.ndarray, *, mesh=None, axis: str = "rows",
                  device=None) -> np.ndarray:
    """APSP of ONE (N, N) matrix with the ROW-BLOCK axis sharded over the
    ranks of a mesh axis, as a host float32 array on every rank.

    Min-plus squaring: N is padded to a multiple of the axis size k with
    isolated nodes (INF rows, a 0 diagonal), and each of the
    ``max(1, ceil(log2(max(npad - 1, 2))))`` squarings ``all_gather``s the
    (npad / k, npad) row blocks and takes ``loc = minplus(loc, full)``
    through ``kernels.minplus.ops`` -- K1 with a batch of one on the card,
    its plain twin on the CPU.  That equals the reference's per-row-block
    pivot loop bit for bit: a min over the same sums, the 0 diagonal
    keeping the old entry among the candidates.  With an axis of one rank
    (or no process group, or no mesh outside one) it is the one-device
    squaring of the whole matrix.  Observed into ``repro_apsp_seconds``
    under the reference's method ``"squaring"``, key and working set."""
    adj = np.asarray(adj, np.float32)
    assert adj.ndim == 2 and adj.shape[0] == adj.shape[1], adj.shape
    n = adj.shape[0]
    dev = eval_device(device)
    mesh, k = _axis_mesh(mesh, axis)
    if k <= 1:
        t0 = time.perf_counter()
        out = apsp(torch.from_numpy(adj).to(dev)).cpu().numpy()
        _observe_call("squaring", ("rowshard", 1, n),
                      time.perf_counter() - t0, 4 * (n * n + 2 * n * n))
        return out
    group = mesh.group(axis)
    npad = -(-n // k) * k
    if npad != n:
        padded = np.full((npad, npad), float(INF), np.float32)
        padded[np.arange(npad), np.arange(npad)] = 0.0
        padded[:n, :n] = adj
        adj = padded
    n_iters = max(1, int(np.ceil(np.log2(max(npad - 1, 2)))))
    rows = npad // k
    t0 = time.perf_counter()
    loc = torch.from_numpy(
        adj[group.index * rows:(group.index + 1) * rows]).to(dev)
    for _ in range(n_iters):
        loc = minplus_ops.minplus(loc, distributed.all_gather(loc, group))
    out = distributed.all_gather(loc, group).cpu().numpy()
    _observe_call("squaring", ("rowshard", k, npad),
                  time.perf_counter() - t0,
                  4 * (npad * npad + 2 * rows * npad))
    return out[:n, :n]
