"""Where two data-parallel ranks' first-step gradients part from one process's.

    python -m orcai_tpu_torch.tools.probe_grad_split [--seed 0] [--device cuda]

One process, with no DDP and no collective (the synced BatchNorm runs in a
gloo group of one). From the bundled orcai-v1 weights, on the first 64
train snippets of chip_smoke.py's training cell (a 20-minute recording
synthesized from --seed, its spectrogram cut into 736 x 171 x 1 snippets
by tools/synthetic.py::synth_tvt), float32 without TF32. Prints three
JSON lines, then the card's name and power limit:

  rows_independent   BatchNorm on its running statistics and dropout off
                     (the LSTMs in training mode, which cuDNN's backward
                     needs), so each row's loss depends on that row alone.
                     The first step's gradients over the 64 rows, the same
                     again (the floor: cuDNN's backward is not
                     deterministic), as two 32-row halves with the loss
                     scaled as Trainer._loss scales it on two ranks and the
                     halves' gradients averaged as DDP averages them, and
                     in float64 (the reference). With cuDNN on and off. By
                     norm, per parameter family: ||a - b|| / ||b||.
  train_mode         BatchNorm on the batch's statistics and dropout on
                     (masks from --seed), as a train step runs: the first
                     step's gradients with cuDNN's BatchNorm (the plain
                     Trainer), the same again, with BatchNorm._forward_sync
                     in the group of one (the distributed Trainer's
                     arithmetic on one rank), and in float64 with the same
                     masks. By norm, per parameter family.
  synced_batchnorm   every BatchNorm of the model in training mode, on its
                     input in the 64-row training forward (dropout masks
                     from --seed): BatchNorm._forward_sync in a gloo group
                     of one against F.batch_norm (cuDNN's on the card),
                     forward (output, running statistics after the update)
                     and backward (input, scale and bias gradients under
                     one upstream gradient drawn from --seed), each also
                     against float64. The largest difference over the
                     layers, and the layer it is in.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

MINUTES = 20.0
ROWS = 64
HALVES = 2


def family(name: str) -> str:
    """The parameter family of a state-dict key: the trunk's convolutions,
    the trunk's BatchNorms, then each head layer by its own name."""
    top, *rest = name.split(".")
    if top == "trunk":
        return "trunk_bn" if "_bn" in rest[0] else "trunk_conv"
    return top


def rel_by_family(a: dict, b: dict) -> dict:
    """||a - b|| / ||b|| per family and over every parameter ("all")."""
    num: dict[str, float] = {}
    den: dict[str, float] = {}
    for key in b:
        for fam in (family(key), "all"):
            num[fam] = num.get(fam, 0.0) + float(((a[key] - b[key]) ** 2).sum())
            den[fam] = den.get(fam, 0.0) + float((b[key] ** 2).sum())
    return {fam: math.sqrt(num[fam] / max(den[fam], 1e-300)) for fam in num}


def first_step_grads(torch, model, x, y, halves: int) -> dict:
    """The first step's gradients with every row independent (see the
    module docstring): over all rows, or over `halves` blocks, each block's
    loss its masked BCE sum times `halves` over every block's count plus
    the l2 term (Trainer._loss on `halves` ranks), each block's gradients
    divided by `halves` and summed (DDP's average)."""
    from orcai_tpu_torch.models import l2_regularization
    from orcai_tpu_torch.models.layers import BiLSTM
    from orcai_tpu_torch.ops.losses import weighted_masked_bce_sums

    lstms = [m for m in model.modules() if isinstance(m, BiLSTM)]
    for m in lstms:
        m.forward = lambda v, train=False, _m=m: BiLSTM.forward(_m, v, True)
    try:
        count = weighted_masked_bce_sums(torch.zeros_like(y), y, None)[1].clamp(min=1)
        total = None
        n = x.shape[0] // halves
        for block in range(halves):
            model.zero_grad(set_to_none=True)
            logits = model(x[block * n:(block + 1) * n], train=False, return_logits=True)
            part = weighted_masked_bce_sums(logits, y[block * n:(block + 1) * n], None)[0]
            (part * halves / count + l2_regularization(model)).backward()
            grads = {k: p.grad.detach() / halves if halves > 1 else p.grad.detach()
                     for k, p in model.named_parameters() if p.grad is not None}
            total = grads if total is None else {k: total[k] + v for k, v in grads.items()}
    finally:
        for m in lstms:
            del m.forward
    return {k: v.double().cpu() for k, v in total.items()}


def rows_independent(torch, model, x, y, cudnn_off: bool = True) -> dict:
    whole = first_step_grads(torch, model, x, y, 1)
    line = {"whole_again_vs_whole": rel_by_family(first_step_grads(torch, model, x, y, 1),
                                                  whole)}
    halves = first_step_grads(torch, model, x, y, HALVES)
    line["halves_vs_whole"] = rel_by_family(halves, whole)
    from orcai_tpu_torch.models.layers import BatchNorm

    ref_model = copy.deepcopy(model).double()
    ref_model.dtype = torch.float64  # the compute dtype
    for m in ref_model.modules():
        if isinstance(m, BatchNorm):
            m.float()  # it normalizes in float32 whatever the compute dtype
    ref = first_step_grads(torch, ref_model, x.double(), y.double(), 1)
    line["whole_vs_float64"] = rel_by_family(whole, ref)
    line["halves_vs_float64"] = rel_by_family(halves, ref)
    if x.is_cuda and cudnn_off:
        with torch.backends.cudnn.flags(enabled=False):
            plain_whole = first_step_grads(torch, model, x, y, 1)
            plain_halves = first_step_grads(torch, model, x, y, HALVES)
        line["cudnn_off"] = {"halves_vs_whole": rel_by_family(plain_halves, plain_whole),
                             "whole_vs_float64": rel_by_family(plain_whole, ref),
                             "halves_vs_float64": rel_by_family(plain_halves, ref)}
    return line


def _bn_run(torch, bn, inp, upstream, sync: bool) -> dict:
    bn = copy.deepcopy(bn)
    bn.sync = sync
    x = inp.clone().requires_grad_(True)
    out = bn(x, train=True)
    (out.double() * upstream.double()).sum().backward()
    return {"output": out.detach(), "running_mean": bn.running_mean, "running_var": bn.running_var,
            "grad_input": x.grad, "grad_scale": bn.weight.grad, "grad_bias": bn.bias.grad}


def _bn_reference(torch, bn, inp, upstream) -> dict:
    """_bn_run's readings computed in float64 by the formula."""
    from orcai_tpu_torch.models.layers import BN_MOMENTUM

    x = inp.double().requires_grad_(True)
    w, b = (p.detach().double().requires_grad_(True) for p in (bn.weight, bn.bias))
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = x.mean(dims)
    var = ((x - mean.view(shape)) ** 2).mean(dims)
    out = (x - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape) * w.view(shape) + b.view(shape)
    (out * upstream.double()).sum().backward()
    keep = BN_MOMENTUM
    return {"output": out.detach(),
            "running_mean": keep * bn.running_mean.double() + (1 - keep) * mean.detach(),
            "running_var": keep * bn.running_var.double() + (1 - keep) * var.detach(),
            "grad_input": x.grad, "grad_scale": w.grad, "grad_bias": b.grad}


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def _train_grads(torch, model, x, y, seed: int, sync: bool) -> dict:
    """The first step's gradients of `model` in training mode
    (Trainer._loss of one process), dropout masks from `seed`."""
    from orcai_tpu_torch.models import l2_regularization
    from orcai_tpu_torch.models.layers import BatchNorm
    from orcai_tpu_torch.ops.losses import weighted_masked_bce_sums

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = sync
    model.set_dropout_generator(torch.Generator(device=x.device).manual_seed(seed + 1))
    logits = model(x, train=True, return_logits=True)
    total, count = weighted_masked_bce_sums(logits, y, None)
    (total / count.clamp(min=1) + l2_regularization(model)).backward()
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
            if p.grad is not None}


def _bn_train_float64(torch, bn, v):
    """BatchNorm's training forward by the formula in v's dtype, in
    F.batch_norm's output layout (a dropout mask drawn next fills memory in
    order)."""
    dims = [d for d in range(v.dim()) if d != 1]
    shape = [1, -1] + [1] * (v.dim() - 2)
    mean = v.mean(dims)
    centered = v - mean.view(shape)
    var = (centered * centered).mean(dims)
    out = centered * torch.rsqrt(var + bn.eps).view(shape)
    return (out * bn.weight.view(shape) + bn.bias.view(shape)).contiguous()


def _dropout_float32_mask(torch, d, v):
    """Dropout's forward with its mask drawn on a float32 tensor, as the
    float32 model draws it (the same numbers in a float64 model)."""
    keep = 1.0 - d.rate
    mask = torch.empty_like(v, dtype=torch.float32).bernoulli_(keep, generator=d.generator)
    return v * mask.to(v.dtype) * (1.0 / keep)


def train_mode(torch, model, x, y, seed: int) -> tuple[dict, dict]:
    """Training mode on the 64 rows (batch statistics, dropout): the
    first step's gradients with cuDNN's BatchNorm (the plain Trainer), the
    same again, with BatchNorm._forward_sync in the group of one (the
    distributed Trainer's arithmetic), and in float64 with the same masks.
    Returns the readings and the float64 gradients."""
    from orcai_tpu_torch.models.layers import BatchNorm, Dropout

    def run(sync: bool) -> dict:
        return _train_grads(torch, copy.deepcopy(model), x, y, seed, sync)

    library = run(False)
    line = {"library_again_vs_library": rel_by_family(run(False), library)}
    synced = run(True)
    line["synced_vs_library"] = rel_by_family(synced, library)
    ref_model = copy.deepcopy(model).double()
    ref_model.dtype = torch.float64
    for m in ref_model.modules():
        if isinstance(m, BatchNorm):
            m.forward = lambda v, train=False, _m=m: _bn_train_float64(torch, _m, v)
        elif isinstance(m, Dropout):
            m.forward = lambda v, train=False, _m=m: _dropout_float32_mask(torch, _m, v)
    ref = _train_grads(torch, ref_model, x.double(), y.double(), seed, False)
    line["library_vs_float64"] = rel_by_family(library, ref)
    line["synced_vs_float64"] = rel_by_family(synced, ref)
    return line, ref


def synced_batchnorm(torch, model, x, seed: int) -> dict:
    """See the module docstring (in the caller's group of one)."""
    from orcai_tpu_torch.models.layers import BatchNorm

    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda m, a, _n=name: inputs.__setitem__(_n, a[0].detach()))
             for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    model.set_dropout_generator(torch.Generator(device=x.device).manual_seed(seed + 1))
    with torch.no_grad():
        model(x, train=True, return_logits=True)
    for h in hooks:
        h.remove()
    layers = dict(model.named_modules())
    gen = torch.Generator(device=x.device).manual_seed(seed + 2)
    worst: dict[str, tuple[float, str]] = {}
    for name, inp in inputs.items():
        bn = layers[name]
        upstream = torch.randn(inp.shape, generator=gen, device=inp.device)
        lib = _bn_run(torch, bn, inp, upstream, False)
        synced = _bn_run(torch, bn, inp, upstream, True)
        ref = _bn_reference(torch, bn, inp, upstream)
        for key in lib:
            for what, a, b in (("synced_vs_library", synced, lib),
                               ("synced_vs_float64", synced, ref),
                               ("library_vs_float64", lib, ref)):
                r = _rel(a[key], b[key])
                tag = f"{what}.{key}"
                if r >= worst.get(tag, (-1.0, ""))[0]:
                    worst[tag] = (r, name)
    line: dict = {"layers": len(inputs)}
    for tag, (r, name) in sorted(worst.items()):
        what, key = tag.split(".")
        line.setdefault(what, {})[key] = {"rel_norm": r, "layer": name}
    return line


def probe(torch, x, y, seed: int, store: Path,
          cudnn_off: bool = True) -> tuple[dict, dict]:
    """The readings on one batch (x, y) on its device, from the bundled
    weights, the synced BatchNorm in a gloo group of one (its FileStore at
    `store`), the cuDNN-off pair only with `cudnn_off`; returns
    ({"rows_independent": ..., "train_mode": ..., "synced_batchnorm": ...},
    the float64 training-mode gradients)."""
    import torch.distributed as dist

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.utils.device import exact_f32_math

    model = load_orcai_model(device=x.device)[0]
    line = {"rows": x.shape[0], "halves": HALVES}
    with exact_f32_math():
        line["rows_independent"] = rows_independent(torch, model, x, y, cudnn_off)
        dist.init_process_group("gloo", store=dist.FileStore(str(store), 1), rank=0,
                                world_size=1)
        try:
            line["train_mode"], reference = train_mode(torch, model, x, y, seed)
            line["synced_batchnorm"] = synced_batchnorm(torch, model, x, seed)
        finally:
            dist.destroy_process_group()
    return line, reference


def training_cell_batch(torch, tmp: Path, seed: int, device):
    """The first ROWS train snippets of chip_smoke.py's training cell."""
    import numpy as np

    from orcai_tpu_torch.io.dataset import ArrayDataset
    from orcai_tpu_torch.io.jsonio import read_json
    from orcai_tpu_torch.io.wav import load_wav_for_frontend
    from orcai_tpu_torch.ops.frontend import make_spectrogram_from_params_device
    from orcai_tpu_torch.resources import DEFAULT_ORCAI_PARAMETER
    from orcai_tpu_torch.tools.synthetic import synth_sweep_wav, synth_tvt

    param = read_json(DEFAULT_ORCAI_PARAMETER)["spectrogram"]
    wav = tmp / "synthetic.wav"
    synth_sweep_wav(wav, seed, MINUTES)
    audio, _ = load_wav_for_frontend(wav, sr=param["sampling_rate"])
    spec, n_frames, _, _ = make_spectrogram_from_params_device(audio, param, device=device)
    synth_tvt(tmp / "tvt", spec[:n_frames].cpu().numpy(), seed, 512, 128, 70)
    ds = ArrayDataset.load(tmp / "tvt" / "train_dataset")
    return (torch.from_numpy(np.asarray(ds.x[:ROWS])).to(device),
            torch.from_numpy(np.asarray(ds.y[:ROWS], np.float32)).to(device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from orcai_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        x, y = training_cell_batch(torch, Path(tmp), args.seed, device)
        line = probe(torch, x, y, args.seed, Path(tmp) / "store")[0]
    for key in ("rows_independent", "train_mode", "synced_batchnorm"):
        print(json.dumps({key: line[key]}), flush=True)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
