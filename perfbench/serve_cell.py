"""A serving cell: the port's ``ServingEngine`` over closed waves.

Set-up makes the weights from the seed, prices the bucket plan over the
mix's lengths (``core/bucketing.py::plan_buckets``, as ``launch/serve.py``
builds it for ragged prompts), builds the engine, runs its selection
warm-up and serves one wave with a prompt at every bucket edge, so every
prefill shape and the decode step have run once.

The window serves whole waves: a wave is submitted, ``engine.run()``
serves it to completion, and a new wave starts while the window's seconds
have not passed.  The engine's ``Model`` is the port's with its
``prefill`` and ``decode_step`` wrapped to stamp the device's timeline
around each call.  Time to first token runs from a stamp taken when the
wave is submitted (the device idle) to the stamp after the request's
prefill; a decode step's time runs from the stamp after the model's
previous call to the one after it, so the host's gaps count.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import traffic, weights, work
from perfbench.common import Clock, build_kernels, free, sync
from perfbench.spec import Cell, port_config


def _recording_model(cfg, device, clock: Clock):
    from repro_torch.nn.model import Model

    class RecordingModel(Model):
        """The port's model with a stamp before and after each prefill
        and decode step; ``on_decode(i)`` (optional) runs before decode
        step ``i`` of the current wave."""

        def prefill(self, params, tokens, last_pos=None, *, extras=None):
            a = clock.stamp()
            out = super().prefill(params, tokens, last_pos, extras=extras)
            self.calls.append(("prefill", a, clock.stamp()))
            return out

        def decode_step(self, params, cache, tokens, pos):
            i = sum(1 for c in self.calls if c[0] == "decode")
            if self.on_decode is not None:
                self.on_decode(i)
            a = clock.stamp()
            out = super().decode_step(params, cache, tokens, pos)
            self.calls.append(("decode", a, clock.stamp()))
            return out

    m = RecordingModel(cfg, device=device)
    object.__setattr__(m, "calls", [])
    object.__setattr__(m, "on_decode", None)
    return m


class ServeCell:
    def __init__(self, cell: Cell, device):
        self.cell, self.run, self.mix = cell, cell.run, cell.traffic
        self.device = torch.device(device)
        self.clock = Clock(self.device)
        self.V = int(self.run["vocab_size"])
        self.waves: List[Dict] = []

    # -- set-up -------------------------------------------------------------

    def setup(self, seed: int) -> None:
        from repro_torch.core.bucketing import plan_buckets
        from repro_torch.kernels import ops
        from repro_torch.launch.engine import ServingEngine, serving_gemms
        self.seed = seed
        build_kernels(self.device)
        mc = port_config(self.run)
        self.flat = weights.make(self.run, seed, self.device)
        self.model = _recording_model(mc, self.device, self.clock)
        weights.check_layout(self.flat, self.model.defs())
        self.plan = plan_buckets(traffic.lengths(self.mix),
                                 gemms=serving_gemms(mc),
                                 hw=ops.get_default_hardware(),
                                 max_buckets=int(self.mix["buckets"]))
        self.max_new = int(self.mix["max_new_tokens"])
        self.engine = ServingEngine(
            self.model, weights.nest(self.flat),
            max_batch=int(self.mix["slots"]),
            max_len=max(self.plan.edges) + self.max_new, plan=self.plan,
            temperature=0.0, seed=seed, quiet=True)
        self.engine.warm_start()
        for i, edge in enumerate(self.plan.edges):
            self.engine.submit(traffic.prompt(seed, (1 << 30) + i, edge,
                                              self.V), max_new_tokens=3)
        self.engine.run()
        sync(self.device)
        self.model.calls.clear()
        self._gen = traffic.waves(self.mix, seed, self.V)

    # -- serving ------------------------------------------------------------

    def _serve_wave(self) -> Dict:
        wave = next(self._gen)
        rids = [self.engine.submit(p, max_new_tokens=self.max_new)
                for _, p in wave]
        self.model.calls.clear()
        start = self.clock.stamp()
        stats = self.engine.run()
        reg = self.engine.run_registry
        return {"prompts": [p for _, p in wave],
                "results": [stats["results"][r] for r in rids],
                "stats": stats, "calls": list(self.model.calls),
                "start": start,
                "real_rows": reg.counter("engine_real_rows").value,
                "padded_rows": reg.counter("engine_padded_rows").value}

    def window(self, seconds: float, waves: Optional[int] = None) -> Dict:
        """Serve whole waves that start within ``seconds`` (or exactly
        ``waves`` waves) and reduce them to the window's numbers."""
        t0 = time.perf_counter()
        self.waves = []
        while True:
            if waves is not None and len(self.waves) >= waves:
                break
            if waves is None and self.waves \
                    and time.perf_counter() - t0 >= seconds:
                break
            self.waves.append(self._serve_wave())
        wall = time.perf_counter() - t0
        return self._reduce(self.waves, wall)

    def _reduce(self, waves: List[Dict], wall: float) -> Dict:
        ms = self.clock.ms
        ttft, pre_ms, pre_t = [], [], []
        dec_ms, steps, dispatch_ms, tokens, failed = 0.0, 0, 0.0, 0, 0
        least_bytes, real, padded = 0.0, 0, 0
        for w in waves:
            pre = [c for c in w["calls"] if c[0] == "prefill"]
            if len(pre) != len(w["results"]):
                raise RuntimeError(f"{len(pre)} prefills for "
                                   f"{len(w['results'])} requests")
            for (_, a, b), r in zip(pre, w["results"]):
                ttft.append(ms(w["start"], b))
                pre_ms.append(ms(a, b))
                pre_t.append(int(r.prompt_len))
            prev = None
            wave_steps = 0
            for kind, a, b in w["calls"]:
                if kind == "decode":
                    dec_ms += ms(prev, b)
                    wave_steps += 1
                prev = b
            steps += wave_steps
            dispatch_ms += w["stats"]["dispatch_s_mean"] * 1e3 \
                * w["stats"]["steps"]
            for r in w["results"]:
                tokens += len(r.tokens)
                failed += int(not r.finished
                              or len(r.tokens) != self.max_new)
            lens = [int(r.prompt_len) for r in w["results"]]
            for j in range(wave_steps):
                least_bytes += work.decode_step_least_bytes(
                    self.run, [n + j for n in lens])
            real += w["real_rows"]
            padded += w["padded_rows"]
        return {"wall_s": wall, "waves": len(waves), "requests": len(ttft),
                "failed": failed, "tokens": tokens, "ttft_ms": ttft,
                "prefill_ms": pre_ms, "prefill_tokens": pre_t,
                "decode_ms": dec_ms, "decode_steps": steps,
                "dispatch_ms": dispatch_ms, "decode_least_bytes": least_bytes,
                "real_rows": real, "padded_rows": padded}

    @staticmethod
    def end_to_end(win: Dict, setup_s: float) -> Dict[str, float]:
        out = {"setup_s": setup_s,
               "serve_tokens_per_s": win["tokens"] / win["wall_s"]}
        if len(win["ttft_ms"]) >= 2:
            out["ttft_p90_ms"] = statistics.quantiles(
                win["ttft_ms"], n=10, method="inclusive")[8]
        if win["decode_steps"]:
            out["tpot_ms"] = win["decode_ms"] / win["decode_steps"]
        return out

    # -- the traced wave ----------------------------------------------------

    def trace_tail(self, capture) -> Dict:
        """One more wave under the profiler: the whole wave, or its decode
        steps [a, b) where the mix names ``trace_decode_steps``.  Returns the capture's summary with
        the work the traced stretch asked of each kernel class."""
        span = self.mix.get("trace_decode_steps")
        if span:
            a, b = span

            def on_decode(i):
                if i == a:
                    capture.start()
                elif i == b and capture.open:
                    capture.stop()
            self.model.on_decode = on_decode
        else:
            capture.start()
        w = self._serve_wave()
        self.model.on_decode = None
        if capture.open:
            capture.stop()
        pk = work.peaks(torch.cuda.get_device_name(self.device))
        slots = len(w["results"])
        steps = range(a, b) if span else range(self.max_new - 1)
        prompts = [] if span else [int(r.prompt_len) for r in w["results"]]
        summary = dict(capture.summary)
        summary["work_s"] = {
            "gemm": sum(work.prefill_gemm_bound_s(self.run, t, pk)
                        for t in prompts)
            + len(steps) * work.decode_gemm_bound_s(self.run, slots, pk),
            "flash": sum(work.prefill_flash_bound_s(self.run, t, pk)
                         for t in prompts)}
        return summary

    # -- the check ----------------------------------------------------------

    def requests(self) -> List[Dict]:
        return [{"prompt": p, "tokens": np.asarray(r.tokens),
                 "padded": int(r.padded_len)}
                for w in self.waves for p, r in zip(w["prompts"],
                                                    w["results"])
                if r.finished]

    def sample(self, seed: int) -> List[Dict]:
        """``check_requests`` finished requests of the window drawn from
        the seed, the longest among them."""
        reqs = self.requests()
        n = min(int(self.mix["check_requests"]), len(reqs))
        size = [len(r["prompt"]) + len(r["tokens"]) for r in reqs]
        longest = int(np.argmax(size))
        rest = [i for i in range(len(reqs)) if i != longest]
        rng = np.random.default_rng([seed & ((1 << 63) - 1), 7])
        pick = [longest] + sorted(rng.choice(rest, size=n - 1,
                                             replace=False).tolist()
                                  if n > 1 else [])
        return [reqs[i] for i in pick]

    def release(self) -> None:
        """Free the program's state; the weights (the harness's inputs)
        stay for the reference."""
        for name in ("engine", "model", "_gen"):
            if hasattr(self, name):
                delattr(self, name)
        free(self.device)

    def check(self, seed: int, control: bool = False) -> Dict[str, float]:
        from perfbench.reference.serve import judge
        return judge(self.flat, self.run, self.sample(seed), self.device,
                     self.cell.limits["settings"]["router_margin"],
                     control=control)
