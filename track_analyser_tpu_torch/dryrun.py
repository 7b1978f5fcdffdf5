"""Multi-process dry run of the port's parallel paths.

    python -m track_analyser_tpu_torch.dryrun --world N [--device cuda|cpu] [--backend nccl|gloo]

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: it
starts N ranks under ``torch.distributed`` (``parallel/mesh.spawn``) and
drives, on every rank:

1. dp analysis: the batched ``substrate.full_track_graph`` with the batch
   of tracks split over the ranks, its outputs all-gathered and held
   against one graph over the whole batch;
2. one dp x tp training step of the GRU downbeat net (hidden 256, 128
   mels): tp shards every hidden-sized axis over a tp group of 2 ranks
   (column-parallel ``in_w``, ``gru*_wx``, ``gru*_wh`` and their biases,
   row-parallel ``out_w``; ``out_b`` replicated), the hidden state is
   all-gathered at every frame through ``mesh.all_gather_grad``, and the
   gradients are summed over the dp group; the updated parameters are
   reassembled and held within 1e-5 of one single-process
   ``downbeat_net.train_step`` on the whole batch;
3. ``analyse_track_sharded`` of one 30 s track over all N ranks.

Ranks run on ``cuda:(rank % device_count)`` (or the CPU with
``--device cpu``); the backend defaults to nccl on CUDA and gloo on the
CPU. NCCL takes one rank per card, so ranks that share a card need
``--backend gloo``. Exits non-zero when a rank fails or a check does not
hold.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np
import torch

from .parallel import mesh
from .parallel.mesh import SeqGroup

__all__ = [
    "dp_batch",
    "seq_track",
    "tp_layout",
    "train_batch",
    "single_process_step",
    "dp_mismatch",
    "step_mismatch",
    "run_dryrun",
    "summarise",
    "main",
]

DP_SR = 44_100
DP_SAMPLES = 512 * 128  # one bucket quantum (~1.5 s)
HIDDEN = 256
N_MELS = 128
FRAMES = 64
STEP_TOL = 1e-5  # relative to each parameter's largest |value|
# the dp lanes against one batched graph: batch widths may round
# differently on the card
DP_ENV_TOL = 1e-5  # relative to the envelope's largest |value|
DP_LUFS_TOL = 1e-3  # LU
SEQ_SR = 22_050
SEQ_SECONDS = 30


def dp_batch(world: int) -> "tuple[np.ndarray, np.ndarray]":
    """(stereo (world, 2, n), n_valid (world,)): one noise lane per rank."""

    ys = np.random.default_rng(0).normal(0, 0.1, size=(world, DP_SAMPLES)).astype(np.float32)
    return np.stack([ys, ys], axis=1), np.full((world,), DP_SAMPLES, dtype=np.int64)


def seq_track() -> np.ndarray:
    """The 30 s 22.05 kHz click-and-tone track of the sequence-sharded
    step (clicks every 0.5 s: 120 BPM)."""

    n = SEQ_SR * SEQ_SECONDS
    t = np.arange(n) / SEQ_SR
    y = (0.2 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    for b in np.arange(0.0, float(SEQ_SECONDS), 0.5):
        s = int(b * SEQ_SR)
        e = min(n, s + 220)
        y[s:e] += np.exp(-np.linspace(0, 6, e - s)).astype(np.float32)
    return y


def tp_layout(world: int) -> "tuple[int, int]":
    """(dp, tp): tp 2 when the world is even, else 1."""

    return (world // 2, 2) if world % 2 == 0 else (world, 1)


def train_batch(dp: int) -> "tuple[np.ndarray, np.ndarray]":
    """The dp x tp step's batch: the JAX dry run's ``synthetic_batch``."""

    from .models.downbeat_net import synthetic_batch

    return synthetic_batch(np.random.default_rng(1), batch=max(dp, 2) * 2, frames=FRAMES, n_mels=N_MELS)


# ---------------------------------------------------------------------------
# The tensor-parallel GRU net.
# ---------------------------------------------------------------------------

_GATES = {"in_w": 1, "in_b": 1, "gru0_wx": 3, "gru0_wh": 3, "gru0_b": 3, "gru1_wx": 3, "gru1_wh": 3, "gru1_b": 3}


def _shard(name: str, value: np.ndarray, tp: int, k: int) -> np.ndarray:
    """tp rank k's part of a JAX-layout parameter: the k-th slice of each
    gate's hidden columns (column-parallel), the k-th block of rows of
    ``out_w`` (row-parallel), ``out_b`` whole."""

    if name == "out_w":
        h = value.shape[0] // tp
        return value[k * h : (k + 1) * h]
    if name not in _GATES:
        return value
    gates = _GATES[name]
    width = value.shape[-1] // gates
    h = width // tp
    return np.concatenate([value[..., gi * width + k * h : gi * width + (k + 1) * h] for gi in range(gates)], axis=-1)


def _unshard(name: str, parts: "list[np.ndarray]") -> np.ndarray:
    """The whole parameter from the tp ranks' parts (``_shard``'s inverse)."""

    if name == "out_w":
        return np.concatenate(parts, axis=0)
    if name not in _GATES:
        return parts[0]
    gates = _GATES[name]
    h = parts[0].shape[-1] // gates
    return np.concatenate([p[..., gi * h : (gi + 1) * h] for gi in range(gates) for p in parts], axis=-1)


def _hidden_gather(x: torch.Tensor, tp: SeqGroup) -> torch.Tensor:
    """(..., h) on each tp rank -> (..., tp * h), differentiable."""

    gathered = mesh.all_gather_grad(x, tp)  # (tp, ..., h)
    return torch.movedim(gathered, 0, -2).reshape(x.shape[:-1] + (-1,))


def _tp_logits(p: Dict[str, torch.Tensor], feats: torch.Tensor, tp: SeqGroup) -> torch.Tensor:
    """Class logits (B, T, 3) of the GRU net from this tp rank's parameter
    shards; the JAX ``forward`` with the hidden axis split."""

    x = torch.tanh(feats @ p["in_w"] + p["in_b"])  # (B, T, h)
    h = x.shape[-1]
    for layer in (0, 1):
        xproj = _hidden_gather(x, tp) @ p[f"gru{layer}_wx"] + p[f"gru{layer}_b"]  # (B, T, 3h)
        state = torch.zeros(x.shape[0], h, dtype=x.dtype, device=x.device)
        outs = []
        for t in range(x.shape[1]):
            hproj = _hidden_gather(state, tp) @ p[f"gru{layer}_wh"]
            xp = xproj[:, t]
            r = torch.sigmoid(xp[:, :h] + hproj[:, :h])
            z = torch.sigmoid(xp[:, h : 2 * h] + hproj[:, h : 2 * h])
            n = torch.tanh(xp[:, 2 * h :] + r * hproj[:, 2 * h :])
            state = (1.0 - z) * n + z * state
            outs.append(state)
        x = torch.stack(outs, dim=1)
    # row-parallel output: the tp ranks' partial products summed
    partial = x @ p["out_w"]
    return mesh.all_gather_grad(partial, tp).sum(dim=0) + p["out_b"]


def _dp_tp_step(world: SeqGroup, lr: float = 1e-3, beta: float = 0.9) -> dict:
    """One dp x tp SGD-with-momentum step; returns the loss and the whole
    updated parameters (JAX layout, numpy)."""

    from .models import downbeat_net

    dp, tp = tp_layout(world.size)
    tp_group = mesh.split_groups(world, [[d * tp + t for t in range(tp)] for d in range(dp)])
    dp_group = mesh.split_groups(world, [[d * tp + t for d in range(dp)] for t in range(tp)])
    dev = world.device
    full = downbeat_net.params_to_jax(
        downbeat_net.init_params(n_mels=N_MELS, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
    )
    p = {
        k: torch.tensor(_shard(k, v, tp, tp_group.rank), device=dev, requires_grad=True)
        for k, v in full.items()
    }
    momentum = {k: torch.zeros_like(v) for k, v in p.items()}
    feats, labels = train_batch(dp)
    per = feats.shape[0] // dp
    mine = slice(dp_group.rank * per, (dp_group.rank + 1) * per)
    f = torch.as_tensor(feats[mine], device=dev)
    lab = torch.as_tensor(labels[mine], device=dev).long()

    logits = _tp_logits(p, f, tp_group)
    logp = torch.log_softmax(logits, dim=-1)
    w = torch.as_tensor((1.0, 10.0, 20.0), device=dev)[lab]
    ce = -logp.gather(-1, lab[..., None])[..., 0]
    w_total = torch.clamp_min(mesh.psum(w.sum(), dp_group), 1.0)
    # The tp ranks of a group compute the same loss: each takes 1 / tp of
    # it, so that the collectives' backward (a sum over ranks) gives the
    # gradient of the whole loss.
    loss = (ce * w).sum() / w_total / tp
    loss.backward()
    with torch.no_grad():
        for k, v in p.items():
            grad = mesh.psum(v.grad, world if k == "out_b" else dp_group)
            m = momentum[k].mul_(beta).add_(grad)
            v.sub_(lr * m)
    total = float(mesh.psum(loss.detach(), world))
    whole = {
        k: _unshard(k, list(mesh.all_gather(v.detach(), tp_group).cpu().numpy())) for k, v in p.items()
    }
    return {"dp": dp, "tp": tp, "loss": total, "params": whole}


def single_process_step(world: int, device: "str | torch.device" = "cuda") -> dict:
    """One single-process ``downbeat_net.train_step`` from the dry run's
    initial parameters on its whole batch: {"loss", "params"}."""

    from .models import downbeat_net

    dp, _ = tp_layout(world)
    feats, labels = train_batch(dp)
    from .device import resolve_device

    model = downbeat_net.init_params(
        n_mels=N_MELS, hidden=HIDDEN, generator=torch.Generator().manual_seed(0)
    ).to(resolve_device(device))
    model, _, loss = downbeat_net.train_step(model, downbeat_net.init_momentum(model), feats, labels)
    return {"loss": float(loss), "params": downbeat_net.params_to_jax(model)}


def dp_mismatch(reports: "list[dict]", device: "str | torch.device" = "cuda") -> "tuple[str | None, float, float]":
    """(what differs or None, max |onset_env diff|, max |LUFS diff|): every
    rank's all-gathered dp outputs against rank 0's (equal) and against
    one ``full_track_graph`` over the whole batch on ``device`` (within
    ``DP_ENV_TOL`` and ``DP_LUFS_TOL``)."""

    from .device import resolve_device
    from .substrate import full_track_graph

    r0 = reports[0]
    for r in reports[1:]:
        if not (np.array_equal(r["dp_onset_env"], r0["dp_onset_env"]) and np.array_equal(r["dp_lufs"], r0["dp_lufs"])):
            return f"rank {r['rank']}'s gathered outputs differ from rank 0's", float("nan"), float("nan")
    dev = resolve_device(device)
    stereo, valids = dp_batch(len(reports))
    with torch.inference_mode():
        out = full_track_graph(torch.from_numpy(stereo).to(dev), torch.from_numpy(valids).to(dev), sr=DP_SR)
    env = out["onset_env"].cpu().numpy()
    lufs = out["integrated_lufs"].cpu().numpy()
    if r0["dp_onset_env"].shape != env.shape:
        return f"onset_env shape {r0['dp_onset_env'].shape} vs {env.shape}", float("nan"), float("nan")
    env_err = float(np.max(np.abs(r0["dp_onset_env"] - env)))
    lufs_err = float(np.max(np.abs(r0["dp_lufs"] - lufs)))
    if env_err > DP_ENV_TOL * float(np.max(np.abs(env))):
        return f"onset_env: max |diff| {env_err}", env_err, lufs_err
    if lufs_err > DP_LUFS_TOL:
        return f"integrated_lufs: max |diff| {lufs_err}", env_err, lufs_err
    return None, env_err, lufs_err


def step_mismatch(got: dict, ref: dict) -> "str | None":
    """None when the dp x tp step equals the single-process step within
    ``STEP_TOL`` (loss and every parameter, relative to its largest
    |value|), else what differs."""

    if abs(got["loss"] - ref["loss"]) > STEP_TOL * abs(ref["loss"]):
        return f"loss {got['loss']} vs {ref['loss']}"
    for k, want in ref["params"].items():
        err = float(np.max(np.abs(got["params"][k] - want)))
        if err > STEP_TOL * float(np.max(np.abs(want))):
            return f"{k}: max |diff| {err}"
    return None


def _rank(world: SeqGroup) -> dict:
    from .parallel.sharded import analyse_track_sharded
    from .substrate import full_track_graph
    from .utils import AudioInput

    report: dict = {"rank": world.rank, "world": world.size, "device": str(world.device), "backend": world.backend}

    # ---- 1. dp analysis ----------------------------------------------------
    t0 = time.perf_counter()
    stereo, valids = dp_batch(world.size)
    with torch.inference_mode():
        out = full_track_graph(
            torch.from_numpy(stereo[world.rank : world.rank + 1]).to(world.device),
            torch.from_numpy(valids[world.rank : world.rank + 1]).to(world.device),
            sr=DP_SR,
        )
        env = mesh.all_gather(out["onset_env"][0], world)
        lufs = mesh.all_gather(out["integrated_lufs"], world)[:, 0]
    report["dp_onset_env"] = env.cpu().numpy()
    report["dp_lufs"] = lufs.cpu().numpy()
    report["dp_s"] = time.perf_counter() - t0

    # ---- 2. dp x tp training step ------------------------------------------
    t0 = time.perf_counter()
    report["step"] = _dp_tp_step(world)
    report["step_s"] = time.perf_counter() - t0

    # ---- 3. sequence-sharded analysis -----------------------------------------
    t0 = time.perf_counter()
    result = analyse_track_sharded(AudioInput(samples=seq_track(), sample_rate=SEQ_SR), world)
    report["seq_bpm"] = result.beat.bpm
    report["seq_key"] = result.harmonic.primary_key.key
    report["seq_lufs"] = result.loudness.integrated_lufs
    report["seq_s"] = time.perf_counter() - t0
    return report


def run_dryrun(
    world: int,
    *,
    device: "str | torch.device" = "cuda",
    backend: "str | None" = None,
    timeout_s: float = mesh.DEFAULT_TIMEOUT_S,
) -> "list[dict]":
    """Every rank's report of the dry run over ``world`` ranks."""

    return mesh.spawn(_rank, world, (), backend=backend, device=device, timeout_s=timeout_s)


def summarise(reports: "list[dict]", device: "str | torch.device" = "cuda") -> int:
    """Print the dry run's lines from the ranks' reports and check them:
    the dp analysis against one batched graph and the dp x tp step against
    one single-process step (both on ``device``), the ranks' results
    against each other. 0 when all hold."""

    r0 = reports[0]
    world = len(reports)
    print(f"[dryrun] {world} ranks, backend {r0['backend']}, rank devices {[r['device'] for r in reports]}")
    mismatch, env_err, lufs_err = dp_mismatch(reports, device)
    if mismatch is not None:
        print(f"[dryrun] dp analysis differs from one batched graph: {mismatch}")
        return 1
    print(
        f"[dryrun] dp analysis: batch={r0['dp_onset_env'].shape[0]} over {world} ranks OK against one batched graph "
        f"(onset_env max |diff| {env_err:.3g}, integrated_lufs {lufs_err:.3g} LU) ({r0['dp_s']:.2f} s)"
    )
    step = r0["step"]
    ref = single_process_step(world, device)
    mismatch = step_mismatch(step, ref)
    if mismatch is not None:
        print(f"[dryrun] dp={step['dp']} x tp={step['tp']} step differs from the single-process step: {mismatch}")
        return 1
    print(
        f"[dryrun] dp={step['dp']} x tp={step['tp']} training step OK, loss={step['loss']:.6f} "
        f"(single process {ref['loss']:.6f}; parameters within {STEP_TOL:g}) ({r0['step_s']:.2f} s)"
    )
    if not all(r["seq_bpm"] == r0["seq_bpm"] and r["seq_key"] == r0["seq_key"] for r in reports):
        print("[dryrun] seq-sharded analysis: the ranks' results differ")
        return 1
    print(
        f"[dryrun] seq-sharded analysis over {world} ranks OK: bpm={r0['seq_bpm']:.2f} "
        f"key={r0['seq_key']} ({r0['seq_s']:.2f} s)"
    )
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m track_analyser_tpu_torch.dryrun", description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True, help="number of ranks")
    ap.add_argument("--device", default="cuda", help="cuda (rank r on cuda:(r %% device_count)) or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"), help="default: nccl on CUDA, gloo on the CPU")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    reports = run_dryrun(args.world, device=args.device, backend=args.backend)
    print(f"[dryrun] ranks ran in {time.perf_counter() - t0:.1f} s")
    return summarise(reports, args.device)


if __name__ == "__main__":
    sys.exit(main())
