"""Stream partitioning with receptive-field overlap (paper §5.3 + §6.1).

Port of `repro.core.stream_partition`. The FPGA splits the symbol stream
over N_i CNN instances through a binary tree of split-stream modules (SSM);
the overlap-generate module (OGM) prepends/appends half a receptive field
of context to every sub-sequence so the BER is flat across chunk borders;
merge-stream modules (MSM) + overlap-remove (ORM) reassemble the output.

Here the split is one zero pad of the whole stream plus a strided view of
it (`Tensor.unfold`: N_i overlapping windows, no copy and no loop over
instances), on the input's device and in the input's dtype; the engine
then runs ONCE over the (N_i, W) batch, exactly as the reference does, and
the merge is a slice and a reshape.

All lengths are in SYMBOLS unless suffixed `_samples` (waveforms carry
N_os samples per symbol).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .equalizer import CNNEqConfig


def overlap_symbols(cfg: CNNEqConfig) -> int:
    """o_sym = (K-1)(1 + V_p(L-1)) / 2 — half receptive field per side."""
    return (cfg.kernel - 1) * (1 + cfg.v_parallel * (cfg.layers - 1)) // 2


def _next_even(n: int) -> int:
    return n if n % 2 == 0 else n + 1


def actual_overlap(cfg: CNNEqConfig, n_inst: int) -> int:
    """o_act = nextEven(⌈o_sym / (V_p·N_i)⌉) · V_p · N_i  (paper §6.1).

    The overlap is added in front of the first SSM where the stream has width
    V_p·N_i and must be divisible by N_os (=2 ⇒ nextEven).
    """
    o_sym = overlap_symbols(cfg)
    return _next_even(math.ceil(o_sym / (cfg.v_parallel * n_inst))) \
        * cfg.v_parallel * n_inst


def chunk_lengths(total_syms: int, n_inst: int) -> int:
    """ℓ_inst: per-instance sub-sequence length (symbols). Raises
    ValueError when the stream does not divide across the instances (the
    stream is never padded to make it divide)."""
    if n_inst < 1 or total_syms % n_inst:
        raise ValueError(f"stream of {total_syms} must divide across "
                         f"{n_inst} instances")
    return total_syms // n_inst


def split_with_overlap(x_samples: torch.Tensor, n_inst: int, o_act: int,
                       n_os: int) -> torch.Tensor:
    """Split a waveform into n_inst overlapped chunks (OGM + SSM tree).

    x_samples: (S·N_os,) → (n_inst, (ℓ_inst + 2·o_act)·N_os), a strided
    view of ONE zero-padded copy of the stream, on x's device and in x's
    dtype. Stream edges are zero-padded (the FPGA pipeline likewise starts
    cold).
    """
    if x_samples.dim() != 1:
        raise ValueError(f"x_samples must be one stream (S·N_os,), got "
                         f"{tuple(x_samples.shape)}")
    l_inst_samp = chunk_lengths(int(x_samples.shape[0]), n_inst)
    o_samp = o_act * n_os
    xp = F.pad(x_samples, (o_samp, o_samp))
    return xp.unfold(0, l_inst_samp + 2 * o_samp, l_inst_samp)


def merge_with_overlap_removal(chunks_syms: torch.Tensor, o_act: int
                               ) -> torch.Tensor:
    """MSM + ORM: drop o_act symbols at each side of each chunk, concat."""
    kept = chunks_syms[:, o_act:chunks_syms.shape[1] - o_act]
    return kept.reshape(-1)


def partitioned_apply(engine, x_samples, n_inst: int,
                      cfg: CNNEqConfig) -> torch.Tensor:
    """Run an equalizer over N_i instances with overlap.

    engine: the production path is a `repro_torch.core.engine.
    EqualizerEngine` (any backend), and x_samples then moves to the
    engine's device; any callable with the same contract — waveform chunks
    (batch, W) → symbols (batch, W//N_os) — also works, and then x stays
    where it is. The waveform must be float32 (a tensor, or a numpy array,
    which is not copied on the host); any other dtype raises TypeError
    rather than being cast. Equal on the interior to running the engine on
    the unsplit stream: every kept symbol is ≥ o_act ≥ o_sym away from a
    chunk edge, and the port's kernels fix each output's summation order,
    so the merged interior is bitwise the unsplit one on every backend.
    """
    x = torch.as_tensor(x_samples, device=getattr(engine, "device", None))
    if x.dtype != torch.float32:
        raise TypeError(f"waveform must be float32, got {x.dtype}")
    o_act = actual_overlap(cfg, n_inst)
    chunks = split_with_overlap(x, n_inst, o_act, cfg.n_os)
    y = engine(chunks)    # batched over instances via the engine's batch dim
    return merge_with_overlap_removal(y, o_act)
