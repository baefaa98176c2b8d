"""Deterministic synthetic LM data pipeline: a copy of
``repro.data.pipeline`` (numpy only), held equal to it batch for batch by
``tests/test_torch_train.py``. Batches are numpy arrays; the train step
moves them to the parameters' device.

Stateless-index design: batch ``i`` is a pure function of (seed, i), so the
pipeline is trivially checkpointable (state = next step index), host-sharded
(each host materializes only its rows), and resume/skip-ahead is O(1) — the
properties a restarted or replaced host needs (DESIGN.md §5 straggler/
fault-tolerance notes).

Token stream: counter-based threefry → Zipf-ish marginal over the vocab (a
uniform stream makes CE trivially flat); labels are next-token shifted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0
    input_mode: str = "tokens"
    d_model: int = 0  # for embeddings mode


class SyntheticLM:
    """Deterministic, seekable synthetic next-token stream."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.step = 0

    # ---- checkpointable state ----------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(state["step"])

    def skip_to(self, step: int) -> None:
        self.step = step

    # ---- generation ------------------------------------------------------
    def _tokens_for(self, step: int) -> np.ndarray:
        c = self.cfg
        rows = c.global_batch // c.n_hosts
        row0 = c.host_index * rows
        rng = np.random.Generator(
            np.random.Philox(key=c.seed, counter=[0, 0, 0, step])
        )
        # zipf-ish marginal: x ~ U^(alpha) scaled into the vocab
        u = rng.random((c.global_batch, c.seq_len + 1))
        toks = (u**3.0 * (c.vocab_size - 1)).astype(np.int32)
        # mix in a learnable bigram structure: t[i+1] depends on t[i]
        toks[:, 1:] = (toks[:, 1:] + (toks[:, :-1] * 31) % 97) % c.vocab_size
        return toks[row0 : row0 + rows]

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self._tokens_for(self.step)
        self.step += 1
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
        }
        if self.cfg.input_mode == "embeddings":
            rng = np.random.Generator(
                np.random.Philox(key=self.cfg.seed + 1, counter=[0, 0, 0, self.step])
            )
            batch["embeds"] = rng.standard_normal(
                (toks.shape[0], self.cfg.seq_len, self.cfg.d_model), dtype=np.float32
            )
            del batch["tokens"]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def for_model(
    cfg: ModelConfig, seq_len: int, global_batch: int, seed: int = 0, **kw
) -> SyntheticLM:
    return SyntheticLM(
        DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            global_batch=global_batch,
            seed=seed,
            input_mode=cfg.input_mode,
            d_model=cfg.d_model,
            **kw,
        )
    )
