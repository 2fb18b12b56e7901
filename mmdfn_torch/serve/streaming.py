"""Streaming per-utterance inference (``mmdfn_tpu/serve/streaming.py``).

A dialogue arrives one utterance at a time, and after each arrival the
server returns the emotion of the newest one.  MM-DFN is not causal (the
text bi-GRU's backward direction and the dynamic adjacency see every
utterance), so each arrival re-runs the whole prefix: one deterministic
forward over ``[:, :L]`` with ``L = bucket_length(t + 1)`` and
``umask = arange(L) <= t``.  The prediction for utterance t equals the
offline model's on the length-(t+1) prefix.

The model's ``text`` argument is the text vector, as ``mmdfn_tpu``'s
session feeds it: right for every multimodal head, the non-graph
baselines and a single-stream model of the text (``modals='l'``).  A
model that reads another modality alone, or the early-fusion
concatenation, is refused: neither server builds that input.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import SERVE_BUCKETS, bucket_length
from mmdfn_torch.device import resolve_device
from mmdfn_torch.runtime import profiling


class StreamingSession:
    """One live dialogue; :meth:`append` returns the newest utterance's
    label and log-probs.  Runs on the card unless ``device="cpu"``."""

    def __init__(self, model: torch.nn.Module, cfg: ExperimentConfig,
                 buckets: Sequence[int] = SERVE_BUCKETS, device=None):
        if cfg.dataset == "DailyDialogue":
            raise ValueError("a DailyDialogue model reads token ids; the "
                             "server feeds a model the text vector (the "
                             "JAX package serves no DailyDialogue model "
                             "either)")
        if cfg.input_modals != "l":
            what = ("the concatenation of modals "
                    f"{','.join(cfg.input_modals)} (mm_fusion_mthd 'concat')"
                    if len(cfg.input_modals) > 1
                    else f"modality {cfg.input_modals!r} alone")
            raise ValueError(f"this model reads {what}; the server feeds a "
                             "model the text vector and builds no other "
                             "input")
        self.device = resolve_device(device)
        info = cfg.info
        self.model = model.to(self.device).eval()
        self.buckets = tuple(buckets)
        self.n_speakers = info["n_speakers"]
        self._dims = {"text": info["D_text"], "audio": info["D_audio"],
                      "visual": info["D_visual"],
                      "qmask": self.n_speakers}
        self._Lmax = max(self.buckets)
        # (1, Lmax, D) buffers on the device, written in place one utterance
        # at a time (the JAX version donated them to its jitted update)
        self._bufs = {k: torch.zeros(1, self._Lmax, D, device=self.device)
                      for k, D in self._dims.items()}
        self._pos = torch.arange(self._Lmax, device=self.device)
        self.t = 0

    def _forward(self, L: int, t: int) -> torch.Tensor:
        b = self._bufs
        umask = (self._pos[:L] <= t).to(torch.float32)[None]
        with torch.inference_mode():
            logp = self.model(b["text"][:, :L], b["qmask"][:, :L], umask,
                              b["audio"][:, :L], b["visual"][:, :L])
        return logp[0, t]

    def warmup(self) -> None:
        """Run every bucket once (builds the kernels, warms the libraries)."""
        for L in self.buckets:
            self._forward(L, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def append(self, text: np.ndarray, audio: np.ndarray,
               visual: np.ndarray, speaker: int) -> Tuple[int, np.ndarray]:
        """Add one utterance; returns (predicted label, log-probs)."""
        t = self.t
        if t >= self._Lmax:
            raise ValueError("dialogue exceeds the largest bucket")
        if not 0 <= speaker < self.n_speakers:
            raise ValueError(f"speaker {speaker} out of range "
                             f"[0, {self.n_speakers})")
        for name, v in (("text", text), ("audio", audio), ("visual", visual)):
            v = np.asarray(v, np.float32)
            if v.shape != (self._dims[name],):
                raise ValueError(f"{name}: expected shape "
                                 f"({self._dims[name]},), got {v.shape}")
            self._bufs[name][0, t].copy_(torch.from_numpy(v))
        self._bufs["qmask"][0, t].zero_()
        self._bufs["qmask"][0, t, speaker] = 1.0
        logp = self._forward(bucket_length(t + 1, self.buckets), t)
        self.t = t + 1
        logp = logp.cpu().numpy()
        return int(np.argmax(logp)), logp

    def reset(self) -> None:
        self.t = 0
        for buf in self._bufs.values():
            buf.zero_()


def measure_latency(model: torch.nn.Module, cfg: ExperimentConfig, dialogues,
                    buckets: Sequence[int] = SERVE_BUCKETS,
                    warmup_dialogues: int = 0, device=None) -> Dict:
    """Feed dialogues utterance by utterance; report per-utterance latency.

    ``p50_ms``/``p90_ms``/``p99_ms`` are host wall times of ``append`` (the
    host-to-device copy, the forward and the log-prob pull).  On the card,
    ``device_ms_by_bucket`` is the stream time between two CUDA events
    around K = 20 chained forwards at that bucket, over K; it includes any
    gap in which the card waits for the host to enqueue work.
    ``device_busy_ms_by_bucket`` is the time the card's kernels ran in K
    more such forwards, over K (``profiling.device_busy_ms``: no host gap
    counts), and ``device_busy_p50_ms`` its median over the appends
    (``mmdfn_tpu/serve/streaming.py:170-216``).
    """
    session = StreamingSession(model, cfg, buckets, device)
    session.warmup()
    for d in dialogues[:warmup_dialogues]:
        session.reset()
        for t in range(len(d)):
            session.append(d.text[t], d.audio[t], d.visual[t],
                           int(np.argmax(d.qmask[t])))
    lat: List[float] = []
    used: List[int] = []
    for d in dialogues:
        session.reset()
        for t in range(len(d)):
            t0 = time.perf_counter()
            session.append(d.text[t], d.audio[t], d.visual[t],
                           int(np.argmax(d.qmask[t])))
            lat.append(time.perf_counter() - t0)
            used.append(bucket_length(t + 1, session.buckets))
    lat_ms = np.asarray(lat) * 1e3
    pct = lambda a, q: float(np.percentile(a, q))
    dev = session.device
    out = dict(n=len(lat), p50_ms=pct(lat_ms, 50), p90_ms=pct(lat_ms, 90),
               p99_ms=pct(lat_ms, 99), mean_ms=float(lat_ms.mean()),
               buckets_used=sorted(set(used)), platform=dev.type,
               device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"))
    if dev.type == "cuda":
        K = 20
        by_bucket: Dict[int, float] = {}
        busy_by_bucket: Dict[int, float] = {}

        def chained(b):
            for _ in range(K):
                session._forward(b, 0)

        for b in sorted(set(used)):
            session._forward(b, 0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chained(b)
            end.record()
            end.synchronize()
            by_bucket[b] = start.elapsed_time(end) / K
            busy_by_bucket[b] = profiling.device_busy_ms(
                lambda: chained(b)) / K
        dev_ms = np.asarray([by_bucket[b] for b in used])
        busy_ms = np.asarray([busy_by_bucket[b] for b in used])
        out.update(device_p50_ms=pct(dev_ms, 50),
                   device_p99_ms=pct(dev_ms, 99),
                   device_ms_by_bucket={str(k): v
                                        for k, v in by_bucket.items()},
                   device_busy_p50_ms=pct(busy_ms, 50),
                   device_busy_ms_by_bucket={
                       str(k): v for k, v in busy_by_bucket.items()})
    return out
