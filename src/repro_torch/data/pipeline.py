"""Deterministic synthetic token pipeline.

Port of ``repro.data.pipeline``, in numpy as the reference's, so a batch
is byte-identical to the reference's for the same config, seed, step and
host. Per-host sharding (each host makes only its slice of the global
batch), a prefetching background thread, and stateless sampling keyed by
(seed, step, host): a restart from checkpoint step N reproduces the same
batch stream.

The generator mixes Zipf-distributed unigrams with repeated n-gram
motifs, so the stream is learnable and loss curves move (uniform tokens
would be incompressible noise). Batches are numpy arrays; the train step
moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass
class SyntheticLMDataset:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    motif_len: int = 16
    n_motifs: int = 512

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab_size
        # Zipf unigram table + fixed motif bank (shared across hosts)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()
        self._motifs = rng.integers(0, v, (self.n_motifs, self.motif_len))

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Stateless: the batch of a global step, this host's slice:
        "tokens" and "labels" (B, S) int32 (labels the next tokens), with
        "frames" (B, encoder_seq, d) float32 for an enc-dec config and
        "frontend" (B, n_patches, d) float32 for a vision-stub one."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4097 + self.host_id)
        B, S, v = self.host_batch, self.seq_len, self.cfg.vocab_size
        toks = rng.choice(v, size=(B, S + 1), p=self._probs)
        # stitch in motifs (learnable structure)
        n_insert = (S // self.motif_len) // 2
        for b in range(B):
            ids = rng.integers(0, self.n_motifs, n_insert)
            offs = rng.integers(0, S + 1 - self.motif_len, n_insert)
            for m, o in zip(ids, offs):
                toks[b, o:o + self.motif_len] = self._motifs[m]
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.is_encdec:
            batch["frames"] = rng.normal(
                0, 1, (B, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32)
        if self.cfg.frontend == "vision_stub":
            batch["frontend"] = rng.normal(
                0, 1, (B, self.cfg.n_patches, self.cfg.d_model)
            ).astype(np.float32)
        return batch


def make_pipeline(ds: SyntheticLMDataset, start_step: int = 0,
                  prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator from ``start_step``. The
    thread stops when the generator is closed or collected."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
