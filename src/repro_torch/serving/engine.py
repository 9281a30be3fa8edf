"""Batched serving engine: prefill + decode with greedy-LPT batch packing.

The port of the reference package's ``serving/engine.py``.  Requests with
heterogeneous prompt lengths are packed into fixed decode batches by the
paper's greedy partitioner (``core.partitioners.pack_items``): the balance
objective that packs equivalence classes onto executors packs prompts onto
batch slots, so padded prefill work is minimized.

On the card every prefill layer runs the flash-attention kernel and every
decode step the decode-attention kernel (``models.attention``).  Sampling:
greedy is ``argmax``; a temperature above 0 samples from a
``torch.Generator`` seeded with ``seed``, which does not reproduce the
reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..core.partitioners import pack_items
from ..models import Model
from .metrics import ServingMetrics, now

__all__ = ["Request", "ServingEngine", "pack_requests"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (L,) int32 token ids
    max_new_tokens: int = 16


def pack_requests(requests: Sequence[Request], n_batches: int):
    """Greedy-LPT pack requests into ``n_batches`` groups balancing total
    prefill tokens (the shared ``core.partitioners.pack_items`` path).
    Returns (assignment, stats)."""
    work = np.array([r.prompt.shape[0] for r in requests], np.float64)
    return pack_items(work, n_batches)


class ServingEngine:
    """Serves requests with ``model`` on the device its ``params`` live on."""

    def __init__(self, model: Model, params, s_max: int,
                 temperature: float = 0.0, seed: int = 0):
        if model.cfg.n_encoder_layers:
            # the reference's engine would fail at its first prefill
            raise ValueError(
                f"{model.cfg.name}: the serving engine takes token prompts "
                "only, as the reference's does; an encoder-decoder is served "
                "by launch.serve_profile.transcribe")
        self.model = model
        self.params = params
        self.s_max = s_max
        self.temperature = temperature
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # same instrumentation layer as the reference: per-request
        # admission->batch->answer latency, aggregated to p50/p99 + QPS
        self.metrics = ServingMetrics()
        # host seconds up to the first sampled tokens of each batch (prefill)
        # and after them (decode), and the decode steps taken
        self.phase_s = {"prefill": 0.0, "decode": 0.0}
        self.decode_steps = 0

    def _sample(self, logits) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        probs = torch.softmax(logits[:, -1] / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(
            torch.int32)

    def generate_batch(self, requests: List[Request]) -> List[np.ndarray]:
        """Prefill a length-homogeneous batch once, then decode.

        Requests in one batch must share a prompt length (``serve`` groups by
        length): the causal prefill has no padding mask, so padding tokens
        would leak into attention.
        """
        b = len(requests)
        lens = np.array([r.prompt.shape[0] for r in requests])
        lmax = int(lens.max())
        if not (lens == lmax).all():
            raise ValueError("generate_batch requires equal prompt lengths; "
                             "use serve() which buckets by length")
        t0 = now()
        toks = torch.from_numpy(np.stack([r.prompt for r in requests]).astype(
            np.int64)).to(self.device)
        with torch.inference_mode():
            logits, cache = self.model.prefill(self.params, {"tokens": toks},
                                               self.s_max)
            max_new = max(r.max_new_tokens for r in requests)
            tok = self._sample(logits)
            first = tok.tolist()          # the host waits for the prefill here
            outs = [[first[i]] for i in range(b)]
            t1 = now()
            for t in range(1, max_new):
                pos = torch.full((b,), lmax + t - 1, dtype=torch.int32,
                                 device=self.device)
                logits, cache = self.model.decode_step(
                    self.params, tok[:, None].long(), cache, pos)
                tok = self._sample(logits)
                step = tok.tolist()
                self.decode_steps += 1
                for i in range(b):
                    if len(outs[i]) < requests[i].max_new_tokens:
                        outs[i].append(step[i])
        t2 = now()
        self.phase_s["prefill"] += t1 - t0
        self.phase_s["decode"] += t2 - t1
        return [np.asarray(o, np.int32) for o in outs]

    def serve(self, requests: List[Request], n_batches: int):
        t_enqueue = now()
        assign, stats = pack_requests(requests, n_batches)
        results: dict = {}
        for gb in range(n_batches):
            group = [r for r, a in zip(requests, assign) if a == gb]
            if not group:
                continue
            t_drain = now()
            # exactness: sub-batch by prompt length (no padding mask in the
            # causal prefill; see generate_batch)
            by_len: dict = {}
            for r in group:
                by_len.setdefault(r.prompt.shape[0], []).append(r)
            for sub in by_len.values():
                outs = self.generate_batch(sub)
                t_answer = now()
                for r, o in zip(sub, outs):
                    results[r.rid] = o
                    self.metrics.record_answer(t_enqueue, t_drain, t_answer)
                self.metrics.record_batch(len(sub))
        stats["latency"] = self.metrics.summary()
        stats["phase_s"] = dict(self.phase_s)
        stats["decode_steps"] = self.decode_steps
        return results, stats
