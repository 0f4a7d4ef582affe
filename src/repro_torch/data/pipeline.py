"""Deterministic synthetic token pipeline (twin of repro.data.pipeline).

Stateless and host-shardable: a batch is a pure function of (seed, step,
global example index), so any host can (re)produce exactly its shard -
which is what makes checkpoint-restart deterministic (a restarted job
replays the identical stream). Swapping in a real tokenised corpus only
replaces `_example`.

Each example draws from a CPU `torch.Generator` seeded from (seed, step,
index), so the stream is the same on every device; it is not the JAX
package's `jax.random` stream (the structure is the same: every other
token repeats its predecessor, shifted, and the codebook variant).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_codebooks: int = 0
    seed: int = 1234


def _generator(cfg: DataConfig, step: int, index: int) -> torch.Generator:
    seed = np.random.SeedSequence([cfg.seed, step, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _example(cfg: DataConfig, step: int, index: int) -> torch.Tensor:
    """One deterministic pseudo-document of seq_len+1 tokens (inputs+label
    shift), structured (markov-ish) so loss can actually decrease."""
    gen = _generator(cfg, step, index)
    s = cfg.seq_len + 1
    base = torch.randint(0, cfg.vocab_size, (s,), generator=gen)
    # inject learnable structure: every other token repeats (shifted) so a
    # model can reach well below uniform loss
    rep = torch.roll(base, 1)
    tok = torch.where(torch.arange(s) % 2 == 0, base,
                      (rep * 31 + 7) % cfg.vocab_size)
    if cfg.num_codebooks:
        cbs = [((tok * (13 + i) + torch.randint(0, 97, (s,), generator=gen))
                % cfg.vocab_size) for i in range(cfg.num_codebooks)]
        return torch.stack(cbs, dim=-1).to(I32)
    return tok.to(I32)


def host_batch(cfg: DataConfig, step: int, host_id: int = 0,
               num_hosts: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels) for this host's slice of the global batch, int32
    on the host (the trainer moves them to its device)."""
    per_host = cfg.global_batch // num_hosts
    ex = torch.stack([_example(cfg, step, host_id * per_host + i)
                      for i in range(per_host)])
    return ex[:, :-1].contiguous(), ex[:, 1:].contiguous()


class DataIterator:
    """Step-indexed iterator with restart support (`start_step`)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = start_step

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        out = host_batch(self.cfg, self.step, self.host_id, self.num_hosts)
        self.step += 1
        return out
