"""Continuous-batching serving engine: request queue -> priced buckets ->
slot-reuse decode, on PyTorch tensors (the port of
``repro/launch/engine.py``).

* **Admission** pops queued requests into free *slots* of a fixed-size
  decode batch.  With a :class:`~repro_torch.core.bucketing.BucketPlan`,
  prompts are right-padded to their bucket edge and each row reads its
  logits out at its true last token (``last_pos``; causal attention makes
  the padded tail invisible).  The prefill cache lands in the slot's rows
  of the decode cache by a generic axis-1 insert.
* **Decode** is one step-synchronous call over all slots with a per-slot
  position vector; each row masks its own prefix and writes KV at its own
  offset.  Finished rows free their slot mid-flight.
* **Warm-up**: every bucket edge's step GEMMs are selected in ONE
  ``select_gemm_config_batch`` call before serving (none for the SSM
  family on one device, which has no attention-step GEMM grid; under
  ``--tp`` its mamba projections at local shapes).
* The SSM and hybrid families take no bucket plan: a recurrent state
  would integrate the pad tokens, so their prompts prefill at exact length
  (``repro/launch/engine.py:116-120``).
* A request may carry its frontend's inputs (``extras``: audio's
  ``frame_embed`` (1, len, D), vision's ``patch_embed`` (1, P, D) with P
  <= len), which its prefill takes (``repro/launch/engine.py:309``).
  Under a bucket plan the frame embeddings are right-padded with zero rows
  to the bucket edge, as the prompt is with pad tokens; the patch
  embeddings cover the first positions whatever the edge.

Fail-soft semantics follow the reference: every prefill/decode is
transient-retried (the fault hook fires before the step touches the cache,
so a retried step replays an intact cache), a
:class:`~repro_torch.runtime.fault_tolerance.PreemptionGuard` drains cleanly
at the loop top, and a faulted run's tokens are a prefix of the clean
run's: temperature sampling draws from a generator seeded per global step
from a pre-split seed table, so a retry or drain never shifts the stream.

The serving loop never waits on the device between ``sync_every``
boundaries: sampled tokens stay on the device (one stack at end of run),
prompts and positions go up by non-blocking copies from pinned memory,
each prefill and decode step is timed by CUDA events
(:class:`~repro_torch.obs.trace.EventTimer`), and nothing reads a device
value back until the boundary, where the
:class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor` records the
sync window's wall time a step alongside the host dispatch time.
``tokens_per_s`` is the tokens over the serving loop's wall time.

With a tracer installed (``obs/trace.py``, looked up at each span), the
engine's track holds per request a ``queue`` span (submit to its
prefill's device start), a device-timed ``prefill`` and a ``request``
span (submit to its last token's device end, ``first_token`` the
prefill's device end), all with its ``rid``; per decode step a
device-timed ``decode_step`` with a host ``sample`` inside; and ``sync``
around each sync boundary, where the tracer's device marks are settled.

Tensor parallelism (a mesh installed in ``meshctx``, ``serve --tp``): every
rank runs the same engine over the same queue in lockstep, each on its own
shards, the model's collectives inside each prefill and decode step.  The
tokens rank 0 samples are broadcast over the "model" axis after every
prefill and decode step, so the ranks never disagree on a token whatever
the last bits of their sums; ``warm_start`` prices the GEMM shapes this
rank launches (:func:`serving_gemms`).

With a :class:`~repro_torch.obs.drift.DriftMonitor` installed, ``warm_start``
records one ``warm_gemm`` row per warm selection (its priced latency
against the event simulator, with config and topology fingerprint: the
residual corrector's training rows) and the decode loop one
``decode_step`` row per sync window (the priced step against the measured
one), both without a host sync of their own.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import meshctx
from repro_torch.core.bucketing import BucketPlan, step_gemms
from repro_torch.core.selector import (get_residual_corrector,
                                       select_gemm_config_batch)
from repro_torch.core.simulator import simulate_gemm
from repro_torch.core.topology import topology_fingerprint
from repro_torch.kernels import ops
from repro_torch.nn import layers as L
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.mamba2 import local_ssm_heads
from repro_torch.nn.model import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.drift import get_drift_monitor, record_step_drift
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StragglerMonitor, retry)

_STEP_RETRIES = 2
_STEP_BASE_DELAY = 0.01
_STEP_MAX_DELAY = 0.1
_SEED_CHUNK = 64


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (len,) int32 token ids
    max_new_tokens: int                 # tokens to emit (incl. prefill's)
    extras: Optional[Dict] = None       # frontend inputs, batch axis of 1
    # (tracer, its "queue" span, its "request" span) when a tracer was
    # installed at submit()
    spans: Optional[Tuple[obs_trace.Tracer, obs_trace.Span,
                          obs_trace.Span]] = None


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    padded_len: int                     # == prompt_len when unpadded
    tokens: np.ndarray                  # (n,) generated ids, n<=max_new
    admit_step: int                     # global step of first decode
    finish_step: int                    # global step after last decode
    finished: bool                      # False when drained mid-flight


@dataclass
class _Slot:
    rid: int = -1
    pos: int = 0                        # next KV write offset for this row
    remaining: int = 0
    admit_step: int = 0

    @property
    def active(self) -> bool:
        return self.rid >= 0


def serving_gemms(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """The (N, K) of one decoder step's GEMMs as ``step_gemms`` prices
    them (a d_model-wide q projection, one d_ff MLP, the head), each at
    the extent this rank launches under the installed mesh: the local q
    and kv heads, the local d_ff and the local vocabulary (a width whose
    split the rules drop stays whole); with no mesh, ``step_gemms``.
    Under a mesh an SSM or hybrid model's list starts with its mamba
    layer's six projections at this rank's SSM heads (in_z, in_x, in_b,
    in_c, in_dt, out_proj); an SSM model has no attention or MLP.

    With no mesh the list stays the JAX engine's (``step_gemms``, and no
    warm-up for the SSM family): the one-process engine primes and prices
    what the reference engine does, row for row
    (``tests/test_torch_engine.py``'s drift parity).  A rank has no
    reference engine to match, so it primes the shapes it launches."""
    swiglu = cfg.activation == "swiglu"
    kv = L.local_kv_heads(cfg) * cfg.head_dim
    ax = meshctx.model_axis()
    if ax is None:
        return step_gemms(cfg.d_model, cfg.d_ff, kv_dim=kv,
                          vocab=cfg.vocab_size, swiglu=swiglu)
    n, D = ax.size, cfg.d_model

    def local(width: int, split: bool) -> int:
        return width // n if split and width % n == 0 else width

    head = [(local(cfg.vocab_size, True), D)]
    mamba = []
    if cfg.has_ssm:
        nh = local_ssm_heads(cfg)
        di = nh * cfg.ssm_head_dim
        ns = cfg.ssm_state
        mamba = [(di, D), (di, D), (ns, D), (ns, D), (nh, D), (D, di)]
    if cfg.family == "ssm":
        return mamba + head
    q = local(D, cfg.num_heads % n == 0)
    f = local(cfg.d_ff, True)
    return mamba + [(q + 2 * kv, D), (D, q), ((2 if swiglu else 1) * f, D),
                    (D, f)] + head


def _agree(tokens: torch.Tensor) -> torch.Tensor:
    """``tokens`` as the "model" axis's first rank sampled them, on every
    rank of the axis (in place; a no-op with no mesh)."""
    ax = meshctx.model_axis()
    if ax is not None:
        import torch.distributed as dist
        dist.broadcast(tokens, src=dist.get_global_rank(ax.group, 0),
                       group=ax.group)
    return tokens


def _to_device(values, device: torch.device) -> torch.Tensor:
    """int64 host values on ``device`` without blocking the host."""
    t = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _extras_at(extras: Optional[Dict], padded: int,
               device: torch.device) -> Optional[Dict]:
    """A request's frontend inputs on ``device`` for a prefill of
    ``padded`` positions: ``frame_embed`` right-padded with zero rows to
    ``padded`` (pad rows sit after the real ones, which causal attention
    keeps from seeing them), ``patch_embed`` as it is."""
    if not extras:
        return None
    out = {}
    for name, v in extras.items():
        t = torch.as_tensor(v, device=device)
        if name == "frame_embed" and t.shape[1] < padded:
            t = torch.cat([t, t.new_zeros((t.shape[0], padded - t.shape[1],
                                           *t.shape[2:]))], dim=1)
        out[name] = t
    return out


def _insert(full: Dict, part: Dict, b: int) -> None:
    """Write each prefill cache leaf (L, 1, ...) into row ``b`` of the
    matching decode cache leaf (L, B, ...), in place, at offset 0 of every
    later axis (nested cache trees leaf by leaf)."""
    for name, dst in full.items():
        src = part[name]
        if isinstance(dst, dict):
            _insert(dst, src, b)
            continue
        idx = (slice(None), slice(b, b + 1)) \
            + tuple(slice(0, n) for n in src.shape[2:])
        dst[idx].copy_(src)


class ServingEngine:
    """One model, one decode batch of ``max_batch`` slots, FIFO admission.

    ``plan`` (optional) buckets ragged prompt lengths; without it every
    distinct length prefills at its exact shape.  ``decode_fault`` is the
    fault-injection hook: called as ``decode_fault(step, guard)`` at the
    top of every decode attempt, before the cache is touched."""

    def __init__(self, model: Model, params: Dict, *,
                 max_batch: int, max_len: int,
                 plan: Optional[BucketPlan] = None,
                 temperature: float = 0.0, seed: int = 0,
                 sync_every: int = 8,
                 decode_fault: Optional[Callable[..., None]] = None,
                 straggler_window: int = 16, straggler_min_steps: int = 4,
                 quiet: bool = False):
        cfg = model.cfg
        if plan is not None and cfg.has_ssm:
            raise ValueError(
                f"bucketed (padded) admission is not exact for family "
                f"{cfg.family!r}: recurrent state integrates pad tokens. "
                f"Run without a plan (exact, per-length compiles).")
        self.model = model
        self.device = model.device
        self.params = params
        self.plan = plan
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.sync_every = max(int(sync_every), 1)
        self.decode_fault = decode_fault
        self._queue: List[Request] = []
        self._next_rid = 0
        self._seed_chunks: Dict[int, np.ndarray] = {}
        self.straggler = StragglerMonitor(window=straggler_window,
                                          min_steps=straggler_min_steps)
        self.retries = 0
        self.quiet = bool(quiet)
        # Per-run metrics registry: ``run()`` rebuilds it, backs the integer
        # stats counters with it, and merge-publishes it into the
        # process-global registry when metrics are enabled.
        self.run_registry: MetricsRegistry = MetricsRegistry()
        # Modeled one-decode-step latency at M = max_batch (the drift
        # monitor's prediction for each sync window); filled by warm_start.
        self.predicted_step_s: Optional[float] = None

    # -- queue -------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               extras: Optional[Dict] = None) -> int:
        """Enqueue one request; returns its rid.  Validates against the
        engine's KV budget up front so admission can't overflow the cache.
        ``extras`` are the request's frontend inputs (numpy arrays or
        tensors with a batch axis of 1): ``frame_embed`` one row a prompt
        token, ``patch_embed`` at most as many."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        for name, v in (extras or {}).items():
            rows = tuple(v.shape)[1]
            if (rows != prompt.size if name == "frame_embed"
                    else rows > prompt.size):
                raise ValueError(f"{name} has {rows} rows for a prompt of "
                                 f"{prompt.size} tokens")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        padded = (self.plan.bucket_for(prompt.size) if self.plan
                  else prompt.size)
        if padded + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"request needs {padded}+{max_new_tokens - 1} cache rows "
                f"> max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), extras=extras)
        tr = obs_trace.get_tracer()
        if tr is not None:
            q = tr.open("queue", "engine", "engine", {"rid": rid})
            life = tr.open("request", "engine", "engine", {"rid": rid})
            life.start = q.start               # both from the submit
            req.spans = (tr, q, life)
        self._queue.append(req)
        return rid

    # -- warm-up -----------------------------------------------------------

    def warm_start(self) -> int:
        """Prime the selector for every shape the serving path will launch:
        each bucket edge's (or queued length's) step GEMMs plus the decode
        batch's, in ONE batched selection call.  Returns shapes primed."""
        cfg = self.model.cfg
        if cfg.family == "ssm" and meshctx.model_axis() is None:
            return 0           # as the reference engine (serving_gemms)
        gemms = serving_gemms(cfg)
        ms = set(self.plan.edges if self.plan
                 else {int(r.prompt.size) for r in self._queue})
        ms.add(self.max_batch)                # the decode step's M extent
        shapes = [(m, n, k) for m in sorted(ms) for (n, k) in gemms]
        hw = ops.get_default_hardware()
        with obs_trace.span("warm_start", cat="engine", track="engine",
                            args={"n_shapes": len(shapes)}):
            sels = select_gemm_config_batch(shapes, hw=hw)
        # The decode step's modeled latency: the summed priced latency of
        # its step GEMMs at M = max_batch — the drift monitor's prediction
        # for every measured sync window.
        self.predicted_step_s = sum(
            s.predicted.total for s, (m, _n, _k) in zip(sels, shapes)
            if m == self.max_batch)
        # Per-GEMM drift rows (site "warm_gemm"): when a drift monitor is
        # installed, check every warm selection's priced latency against
        # the event simulator.  Unlike the whole-step decode rows (config
        # None), these carry a config AND the topology fingerprint — the
        # residual corrector's training set (DESIGN.md §12).
        mon = get_drift_monitor()
        if mon is not None:
            for s in sels:
                try:
                    meas = simulate_gemm(s.problem, s.config, hw).time
                except (ValueError, RuntimeError):
                    continue
                mon.record_selection(s, meas, site="warm_gemm")
        return len(shapes)

    # -- serving loop ------------------------------------------------------

    def _step_seed(self, step: int) -> int:
        """The sampling seed of one global step, from a table pre-split in
        chunks: independent of retries, drains and batch composition."""
        c, r = divmod(step, _SEED_CHUNK)
        chunk = self._seed_chunks.get(c)
        if chunk is None:
            chunk = self._seed_chunks[c] = np.random.default_rng(
                [self.seed, c]).integers(0, 2**62, size=_SEED_CHUNK)
        return int(chunk[r])

    def _sample(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        # Gumbel-max: argmax(logits / t + G) is a draw from softmax(logits/t)
        # and runs on the device with no host round trip.
        g = torch.Generator(device=logits.device)
        g.manual_seed(self._step_seed(step))
        u = torch.rand(logits.shape, generator=g, device=logits.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits.float() / self.temperature + gumbel,
                            dim=-1)

    def _status(self, msg: str) -> None:
        obs_trace.event("status", cat="engine", track="engine",
                        args={"msg": msg})
        if not self.quiet:
            print(f"[engine] {msg}")

    def _count_retry(self, attempt: int, err: Exception) -> None:
        self.retries += 1
        self.run_registry.counter("engine_retries").inc()
        obs_metrics.inc("engine_retries")
        obs_trace.event("step_retry", cat="fault", track="engine",
                        args={"attempt": attempt + 1, "error": repr(err)})
        self._status(f"transient fault absorbed "
                     f"(attempt {attempt + 1}): {err!r}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run(self) -> Dict:
        """Serve the queue to completion (or preemption drain); returns the
        stats dict (DESIGN.md §10's schema)."""
        B = self.max_batch
        dev = self.device
        slots = [_Slot() for _ in range(B)]
        cache = self.model.init_cache(B, self.max_len)
        tokens = torch.zeros((B,), dtype=torch.int64, device=dev)
        pos_host = [0] * B
        tok_log: List[torch.Tensor] = []     # per-step (B,) device tensors
        owners: List[Tuple[int, ...]] = []   # per-step slot->rid snapshot
        first_tok: Dict[int, torch.Tensor] = {}  # rid -> (1,) prefill token
        meta: Dict[int, Tuple[int, int, int]] = {}  # rid -> (plen,padded,adm)
        finished: Dict[int, int] = {}        # rid -> finish_step
        reg = self.run_registry = MetricsRegistry()
        c_real = reg.counter("engine_real_rows")
        c_padded = reg.counter("engine_padded_rows")
        timer = obs_trace.EventTimer(dev.type == "cuda")
        pre_marks: List[Tuple] = []        # (start, end) a prefill, unread
        step_marks: List[Tuple] = []       # (start, end) a decode step
        step_s: List[float] = []           # each decode step's device s
        t_prefill = 0.0
        # rid -> (tracer, "request" span) of requests in flight
        open_req: Dict[int, Tuple[obs_trace.Tracer, obs_trace.Span]] = {}
        drift_on = (self.predicted_step_s is not None
                    and get_drift_monitor() is not None)
        topo_fp = (topology_fingerprint(ops.get_default_hardware())
                   if drift_on else "")
        dispatch_acc: List[float] = []
        drained = False
        step = 0

        def sync() -> float:
            """The sync boundary: the tracer reads the marks it anchored at
            the last one while the device still runs, then, once synced,
            the prefill seconds and each decode step's device seconds are
            read and the tracer anchors its marks.  Returns the wall clock
            at the sync."""
            nonlocal t_prefill
            tr = obs_trace.get_tracer()
            if tr is not None:
                tr.read()
            with obs_trace.span("sync", cat="engine", track="engine"):
                self._sync()
                now = time.perf_counter()
                t_prefill += sum(timer.seconds(a, b) for a, b in pre_marks)
                step_s.extend(timer.seconds(a, b) for a, b in step_marks)
                timer.recycle([m for ab in pre_marks + step_marks
                               for m in ab])
                pre_marks.clear()
                step_marks.clear()
                if tr is not None:
                    tr.settle()
            return now

        def close_request(rid: int, tr, mark) -> None:
            """End a request's span at ``mark``, its last token's device
            end, if the tracer that opened it is still ``tr``."""
            tr_sp = open_req.pop(rid, None)
            if tr_sp is not None and tr_sp[0] is tr:
                tr.close(tr_sp[1], device_end=mark)

        def admit(b: int) -> None:
            nonlocal tokens
            req = self._queue.pop(0)
            plen = int(req.prompt.size)
            padded = (self.plan.bucket_for(plen) if self.plan else plen)
            tr = obs_trace.get_tracer()
            mine = req.spans is not None and req.spans[0] is tr
            if mine:        # the wait ends where the prefill's work starts
                tr.close(req.spans[1], device_end=tr.mark())
            with (tr.span("prefill", "engine", "engine",
                          args={"rid": req.rid, "slot": b,
                                "prompt_len": plen, "padded_len": padded},
                          device=True)
                  if tr is not None else obs_trace.NULL_SPAN):
                prompt = np.zeros((1, padded), np.int64)
                prompt[0, :plen] = req.prompt
                prompt_dev = _to_device(prompt, dev)
                last_pos = (_to_device([plen - 1], dev)
                            if padded != plen else None)
                extras = _extras_at(req.extras, padded, dev)
                mark = timer.mark()
                logits, pc = retry(
                    lambda: self.model.prefill(self.params, prompt_dev,
                                               last_pos, extras=extras),
                    retries=_STEP_RETRIES, base_delay=_STEP_BASE_DELAY,
                    max_delay=_STEP_MAX_DELAY, on_retry=self._count_retry)
                _insert(cache, pc, b)
                tok = _agree(torch.argmax(logits, dim=-1))     # (1,)
                # Out of place: the step log holds the previous tensor.
                tokens = tokens.clone()
                tokens[b] = tok[0]
                pre_marks.append((mark, timer.mark()))
            if mine:
                first = tr.mark()
                tr.place(req.spans[2], "first_token", first)
                open_req[req.rid] = (tr, req.spans[2])
            first_tok[req.rid] = tok
            slots[b].rid = req.rid
            slots[b].pos = plen
            slots[b].remaining = req.max_new_tokens - 1
            slots[b].admit_step = step
            pos_host[b] = plen
            meta[req.rid] = (plen, padded, step)
            reg.counter("engine_bucket_hits",
                        labels={"edge": str(padded)}).inc()
            c_real.inc(plen)
            c_padded.inc(padded)
            if slots[b].remaining == 0:       # single-token request
                finished[req.rid] = step
                slots[b].rid = -1
                if mine:
                    close_request(req.rid, tr, first)

        t_run0 = t_sync = time.perf_counter()
        pref_at_sync = 0.0
        with PreemptionGuard() as guard:
            while True:
                if guard.should_stop:
                    if any(s.active for s in slots) or self._queue:
                        drained = True
                        self._status(f"preemption requested; draining "
                                     f"after {step} decode steps")
                    break
                for b in range(B):
                    if not slots[b].active and self._queue:
                        admit(b)
                if not any(s.active for s in slots):
                    break
                this_step = step

                def body():
                    # Fault hook fires BEFORE decode: a retried step
                    # replays an intact cache.
                    if self.decode_fault is not None:
                        self.decode_fault(this_step, guard)
                    return self.model.decode_step(self.params, cache,
                                                  tokens, pos_dev)

                tr = obs_trace.get_tracer()
                with (tr.span("decode_step", "engine", "engine",
                              args={"step": this_step,
                                    "active": sum(1 for s in slots
                                                  if s.active)},
                              device=True)
                      if tr is not None else obs_trace.NULL_SPAN):
                    pos_dev = _to_device(pos_host, dev)
                    td0 = time.perf_counter()
                    mark = timer.mark()
                    logits, cache = retry(
                        body, retries=_STEP_RETRIES,
                        base_delay=_STEP_BASE_DELAY,
                        max_delay=_STEP_MAX_DELAY,
                        on_retry=self._count_retry)
                    with obs_trace.span("sample", cat="engine",
                                        track="engine"):
                        tokens = _agree(self._sample(logits, step))
                    step_marks.append((mark, timer.mark()))
                    dispatch_acc.append(time.perf_counter() - td0)
                tok_log.append(tokens)
                owners.append(tuple(s.rid for s in slots))
                ended = []
                for b in range(B):
                    s = slots[b]
                    if not s.active:
                        continue
                    s.pos += 1
                    pos_host[b] = s.pos
                    s.remaining -= 1
                    if s.remaining == 0:
                        finished[s.rid] = step + 1
                        ended.append(s.rid)
                        s.rid = -1            # slot free: reused next admit
                if open_req and ended:
                    tr = obs_trace.get_tracer()
                    end = tr.mark() if tr is not None else None
                    for rid in ended:
                        close_request(rid, tr, end)
                step += 1
                if step % self.sync_every == 0:
                    now = sync()
                    # Prefill is its own stat: take it out of the window.
                    window = now - t_sync - (t_prefill - pref_at_sync)
                    t_sync, pref_at_sync = now, t_prefill
                    n = min(self.sync_every, len(dispatch_acc))
                    device_s = window / max(n, 1)
                    dispatch_s = sum(dispatch_acc[-n:]) / max(n, 1)
                    msg = self.straggler.record(device_s,
                                                dispatch_s=dispatch_s)
                    if msg:
                        reg.counter("engine_straggler_flags").inc()
                        obs_metrics.inc("engine_straggler_flags")
                        obs_trace.event(
                            "straggler_flag", cat="engine", track="engine",
                            args={"step": step, "device_step_s": device_s,
                                  "dispatch_s": dispatch_s, "msg": msg})
                        self._status(msg)
                    if obs_metrics.metrics_enabled():
                        obs_metrics.set_gauge("engine_queue_depth",
                                              len(self._queue))
                        obs_metrics.set_gauge(
                            "engine_slot_occupancy",
                            sum(1 for s in slots if s.active) / B)
                    if drift_on:
                        record_step_drift(
                            site="decode_step", shape=(B,),
                            predicted_s=self.predicted_step_s,
                            measured_s=device_s, topo=topo_fp,
                            step=step, dispatch_s=dispatch_s)
        wall = sync() - t_run0
        t_decode = time.perf_counter() - t_run0 - t_prefill
        rem = step % self.sync_every
        if rem:                   # tail window shorter than sync_every
            window = time.perf_counter() - t_sync \
                - (t_prefill - pref_at_sync)
            self.straggler.record(
                window / rem, dispatch_s=sum(dispatch_acc[-rem:]) / rem)
            if drift_on:
                record_step_drift(
                    site="decode_step", shape=(B,),
                    predicted_s=self.predicted_step_s,
                    measured_s=window / rem, topo=topo_fp,
                    step=step, dispatch_s=sum(dispatch_acc[-rem:]) / rem)

        # One transfer for the whole run: stack the device-side step log.
        decoded = (torch.stack(tok_log).cpu().numpy() if tok_log
                   else np.zeros((0, B), np.int64))
        firsts = {r: int(t.cpu()[0]) for r, t in first_tok.items()}
        results: Dict[int, RequestResult] = {}
        emitted = 0
        for rid, (plen, padded, adm) in meta.items():
            fin = finished.get(rid, step)
            cols = [firsts[rid]]
            for s_ in range(adm, fin):
                b = owners[s_].index(rid) if rid in owners[s_] else -1
                if b >= 0:
                    cols.append(int(decoded[s_, b]))
            results[rid] = RequestResult(
                rid=rid, prompt_len=plen, padded_len=padded,
                tokens=np.asarray(cols, np.int32), admit_step=adm,
                finish_step=fin, finished=rid in finished)
            emitted += len(cols)
        real_rows, padded_rows = c_real.value, c_padded.value
        pad_frac = (1.0 - real_rows / padded_rows) if padded_rows else 0.0
        bucket_hits = {int(dict(m.labels)["edge"]): m.value
                       for m in reg.metrics()
                       if m.name == "engine_bucket_hits"}
        tokens_per_s = emitted / max(wall, 1e-9)
        reg.counter("engine_steps").inc(step)
        reg.counter("engine_tokens_emitted").inc(emitted)
        reg.gauge("engine_tokens_per_s").set(tokens_per_s)
        reg.gauge("engine_pad_fraction").set(pad_frac)
        if obs_metrics.metrics_enabled():
            obs_metrics.get_registry().merge(reg)
        return {
            "results": results,
            "steps": step,
            "drained": drained,
            "retries": self.retries,
            "stragglers": list(self.straggler.flagged),
            "t_prefill_s": t_prefill,
            "t_decode_s": t_decode,
            "tokens_emitted": emitted,
            "tokens_per_s": tokens_per_s,
            "bucket_hits": dict(sorted(bucket_hits.items())),
            "pad_fraction": pad_frac,
            "dispatch_s_mean": (sum(dispatch_acc) / len(dispatch_acc)
                                if dispatch_acc else 0.0),
            "device_step_s_mean": (sum(step_s) / len(step_s)
                                   if step_s else 0.0),
            "queued_left": len(self._queue),
            "residual_active": get_residual_corrector() is not None,
        }
