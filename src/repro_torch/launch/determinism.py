"""Is a gloo world of CPU ranks deterministic? Run the vocab-parallel CE
(`models.transformer.next_token_ce` on DTensor logits, forward and
backward) on a 2 × 2 mesh of spawned ranks, many times, and find the
first op whose output changes from run to run.

Each rank runs under `OpHashes`, a `TorchDispatchMode` that hashes the
inputs and the output of every local op and runs each aten op once more
on cloned inputs: an op whose output differs from that rerun, on inputs
that did not change, computes differently from call to call. Busy-loop
processes (``--contend``) load the host's cores meanwhile.

    python -m repro_torch.launch.determinism --threads 2 --worlds 40 \\
        --contend 2 [--no-rank-env]

``--no-rank-env`` leaves `launch.mesh.RANK_ENV` out of the ranks'
environment (the ranks then run oneMKL without its reproducible mode).
Prints one line a world and, at the end, the counts as JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

# the vocab-parallel CE's test case: a padded vocabulary, labels in both
# ranks' columns, a prefix before the text
VOCAB, V_PAD, B, S, START = 300, 384, 4, 11, 3
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided"}


def case(seed: int = 0):
    """f32 logits (B, S, V_PAD), the padded columns set large, and labels
    (B, S − START) spread over both halves of the vocabulary."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V_PAD)) * 3).astype(np.float32)
    logits[..., VOCAB:] += 40.0
    labels = rng.integers(0, VOCAB, (B, S - START)).astype(np.int32)
    labels[:, ::2] = rng.integers(V_PAD // 2, VOCAB, labels[:, ::2].shape)
    labels[:, 1::2] = rng.integers(0, V_PAD // 2, labels[:, 1::2].shape)
    return logits, labels


def _hash(t) -> str:
    if type(t) is not torch.Tensor or t.numel() == 0:
        return ""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return hashlib.blake2b(raw.tobytes(), digest_size=8).hexdigest()


class OpHashes(TorchDispatchMode):
    """Each local op as (name, output hashes, input hashes) in ``log``: a
    collective's output is hashed when it is waited for, and the aten ops
    on plain tensors are rerun on cloned inputs. Where a rerun differs,
    ``moved`` gets (log index, name, elements that differ of all, their
    largest relative difference)."""

    def __init__(self):
        super().__init__()
        self.log: list = []
        self.moved: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._overloadpacket.__name__
        tensors = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        rerun = (func.namespace == "aten" and name not in _NO_DATA
                 and all(type(t) is torch.Tensor for t in tensors))
        if rerun:
            ins = [_hash(t) for t in tensors]
            again = tree_map(lambda t: t.clone() if type(t) is torch.Tensor
                             else t, (args, kwargs))
        out = func(*args, **kwargs)
        if name in _NO_DATA or (func.namespace == "_c10d_functional"
                                and name != "wait_tensor"):
            self.log.append((str(func), "", ""))
            return out
        outs = [_hash(t) for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if rerun:
            second = func(*again[0], **again[1])
            if outs != [_hash(t) for t in tree_leaves(second)
                        if isinstance(t, torch.Tensor)]:
                a, b = (tree_leaves(t)[0].double() for t in (out, second))
                rel = (a - b).abs() / b.abs().clamp_min(1e-30)
                self.moved.append((len(self.log), str(func),
                                   int((a != b).sum()), a.numel(),
                                   float(rel.max())))
        self.log.append((str(func), ",".join(outs),
                         ",".join(ins) if rerun else ""))
        return out


def ce_rank(rank: int, world: int, threads: int, logits, labels):
    """One rank: the CE and its gradient under `OpHashes` with ``threads``
    intra-op threads; the loss, this rank's gradient shard, the op log,
    the ops unlike their rerun and the rank's MKL_CBWR."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..models import transformer
    from ..parallel import sharding
    from .mesh import make_mesh
    torch.set_num_threads(threads)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    rows = slice(d * B // 2, (d + 1) * B // 2)
    cols = slice(m * V_PAD // 2, (m + 1) * V_PAD // 2)
    sharding.set_mesh(mesh, "train")
    mode = OpHashes()
    try:
        lg = DTensor.from_local(
            torch.from_numpy(logits[rows, :, cols]).requires_grad_(True),
            mesh, [Shard(0), Shard(2)], run_check=False)
        lb = DTensor.from_local(torch.from_numpy(labels[rows]), mesh,
                                [Shard(0), Replicate()], run_check=False)
        with mode:
            loss = transformer.next_token_ce(lg, lb, VOCAB, START)
            (g,) = torch.autograd.grad(loss, lg)
            loss = loss.full_tensor()
        return {"loss": loss.detach(), "grad": g.to_local(),
                "log": mode.log, "moved": mode.moved,
                "mkl_cbwr": os.environ.get("MKL_CBWR")}
    finally:
        sharding.set_mesh(None)


def _busy(parent: int) -> None:
    """Spin until the process that started this one is gone."""
    while os.getppid() == parent:
        pass


def first_difference(log, base) -> Optional[tuple]:
    """(index, this op, the base run's op) of the first op whose output
    differs from ``base``'s, or None."""
    for i, (a, b) in enumerate(zip(log, base)):
        if a[:2] != b[:2]:
            return i, a, b
    return None


def main(argv=None) -> int:
    from . import mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--worlds", type=int, default=20)
    ap.add_argument("--contend", type=int, default=0,
                    help="busy-loop processes beside the worlds")
    ap.add_argument("--no-rank-env", action="store_true")
    args = ap.parse_args(argv)
    if args.no_rank_env:
        mesh.RANK_ENV = {}
    logits, labels = case()
    hogs = [multiprocessing.get_context("spawn").Process(
        target=_busy, args=(os.getpid(),), daemon=True)
        for _ in range(args.contend)]
    for h in hogs:
        h.start()
    base, differ, reruns = None, 0, 0
    try:
        for w in range(args.worlds):
            outs = mesh.run_ranks(ce_rank, 4, (args.threads, logits,
                                               labels), timeout_s=600)
            base = base or outs
            odd = [(r, *m) for r, o in enumerate(outs) for m in o["moved"]]
            moved = [(r, first_difference(o["log"], b["log"]))
                     for r, (o, b) in enumerate(zip(outs, base))
                     if not (torch.equal(o["loss"], b["loss"])
                             and torch.equal(o["grad"], b["grad"]))]
            differ += bool(moved)
            reruns += bool(odd)
            print(f"world {w}: "
                  f"{'differs from' if moved else 'as'} world 0; ops unlike "
                  f"their rerun {odd}; first moved op by rank {moved}",
                  flush=True)
    finally:
        for h in hogs:
            h.kill()
    print(json.dumps({"threads": args.threads, "worlds": args.worlds,
                      "contend": args.contend, "rank_env": mesh.RANK_ENV,
                      "ranks_mkl_cbwr": outs[0]["mkl_cbwr"],
                      "worlds_differing_from_world_0": differ,
                      "worlds_with_an_op_unlike_its_rerun": reruns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
