"""B1 (ops/dft.py::dft_magnitude) of two trees of this package, timed in
turns on one CUDA device.

    python -m orcai_tpu_torch.tools.ab_b1_sizes --trees A B [--sizes 384/192,352/176,...]
        [--frames 32768] [--dtype int16] [--iters 20] [--rounds 2] [--seed 0]

A and B are directories that hold an orcai_tpu_torch package (this
checkout and another commit's, unpacked with `git archive`). The two
packages share a name, so each run is a process of its own that imports
its tree's package; the runs go A, B, B, A for each of --rounds. A run
builds its tree's kernels (once a tree: the build stays in its _build/),
makes a tile of --frames frames (or the frames a size names, n_fft/hop/
frames) at each n_fft / hop of --sizes from --seed (--dtype: int16, uint8
mu-law codes of it, or float32), holds dft_magnitude
against the tree's plain version (atol 2e-4, or 2e-4 of the float64 rFFT
where the plain fp32 GEMM is itself farther; above n_fft 8192, where it
is, and its tables take seconds to build, against the float64 rFFT of the
first 512 frames alone) and times it with
CUDA events over --iters launches behind a short device spin. Prints one
JSON line of every run's ms by size, whether the two trees' outputs are
bit-equal at each size (a sha256 of each run's output) and, where they are
not, their largest difference on the first 64 frames, and each size whose
check failed in a tree's run (timed all the same; the tool then exits 1),
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# the mixed route's compiled layout (the spectral wires' 384 and 352), its
# warp layout (768, 704, 416, 480, 1024, 2048, radices 17, 19, 23, 29 and
# 31) and block layout (4096, 8192, 4352; 4078, the chirp mode on M =
# 8192, beside 2038's M = 4096), the cluster route's compiled
# plans (16384, 32768, and 65536 on 8 CTAs of one an SM, on 11251 frames)
# and its generic kernel (20736, radix 3, and 40960, radix 5, on 11251
# frames), the chirp mode on both layouts (24578 on 8 CTAs of one an SM,
# on 11251 frames) and the staged route: its FFT mode (14848 = 2^9 * 29 on
# 301 frames, 98304 and 131072 on 2048, and on 301 frames 17856, 33408 and
# 270336, whose columns of 64, 128 and 512 points run the kernels compiled
# whole that no other size here runs, and 10672, whose one-pass columns of
# 16 do not) and its chirp mode (40962 and 49154 on 301 frames)
DEFAULT_SIZES = ("384/192,352/176,768/384,704/352,416/208,480/240,1024/256,2048/512,1088/544,"
                 "1216/608,1472/736,368/184,464/232,496/248,1856/928,1984/992,4096/2048,4078/2039,"
                 "8192/4096,4352/2176,16384/8192,32768/16384,65536/32768/11251,"
                 "20736/10368/11251,40960/20480/11251,470/235,2038/1019,8198/4099,16418/8209,"
                 "24578/12289/11251,14848/7424/301,40962/20481/301,49154/24577/301,"
                 "98304/49152/2048,131072/65536/2048,10672/5336/301,17856/8928/301,"
                 "33408/16704/301,270336/135168/301")

RUN = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from orcai_tpu_torch.ops.dft import dft_magnitude, dft_magnitude_plain
from orcai_tpu_torch.ops.frontend import hann_window
from orcai_tpu_torch.ops.wire_codec import mulaw_decode_f32, mulaw_encode

sizes, default_frames, iters, seed = json.loads(sys.argv[2]), *map(int, sys.argv[3:6])
kind, keep = sys.argv[6], sys.argv[7]
dev = torch.device("cuda")
out, sha, failed = {}, {}, {}
for n_fft, hop, *named in sizes:
    frames = named[0] if named else default_frames
    rng = np.random.default_rng(seed + n_fft)
    n = (frames - 1) * hop + n_fft
    pcm = rng.integers(-32768, 32768, n, dtype=np.int16)
    x = torch.from_numpy({"int16": pcm, "uint8": mulaw_encode(pcm),
                          "f32": (0.3 * rng.standard_normal(n)).astype(np.float32)}[kind]).to(dev)
    x64 = {"int16": lambda: x.double() / 32768.0, "uint8": lambda: mulaw_decode_f32(x).double(),
           "f32": lambda: x.double()}[kind]
    window = hann_window(n_fft)
    got = dft_magnitude(x, window, n_fft=n_fft, hop=hop)
    key = "/".join(map(str, (n_fft, hop, *named)))
    sha[key] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    if keep:
        np.save(f"{keep}/{n_fft}-{hop}-{frames}.npy", got[:64].cpu().numpy())
    if n_fft > 8192:
        frames64 = x64()[:511 * hop + n_fft].unfold(0, n_fft, hop)
        exact = torch.fft.rfft(frames64 * torch.from_numpy(window).to(dev), dim=1).abs()
        kernel = float((got[:512] - exact).abs().max())
        if not kernel <= 2e-4:
            failed[key] = f"kernel {kernel} from the float64 rFFT"
        del frames64, exact
    want = got if n_fft > 8192 else dft_magnitude_plain(x, window, n_fft=n_fft, hop=hop)
    err = float((got - want).abs().max())
    if not err <= 2e-4:
        frames64 = x64().unfold(0, n_fft, hop)
        exact = torch.fft.rfft(frames64 * torch.from_numpy(window).to(dev), dim=1).abs()
        kernel, plain = float((got - exact).abs().max()), float((want - exact).abs().max())
        if not (plain > 2e-4 and kernel <= 2e-4):
            failed[key] = (f"kernel {err} from plain; against float64 kernel {kernel}, "
                           f"plain {plain}")
        del frames64, exact
    del got, want
    for _ in range(3):
        dft_magnitude(x, window, n_fft=n_fft, hop=hop)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(8_000_000)
    start.record()
    for _ in range(iters):
        dft_magnitude(x, window, n_fft=n_fft, hop=hop)
    end.record()
    end.synchronize()
    out[key] = start.elapsed_time(end) / iters
print(json.dumps({"ms": out, "sha256": sha, "failed": failed}))
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    parser.add_argument("--sizes", default=DEFAULT_SIZES)
    parser.add_argument("--frames", type=int, default=32768)
    parser.add_argument("--dtype", choices=("int16", "uint8", "f32"), default="int16")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_b1_sizes: no CUDA device")
    import numpy as np

    sizes = [[int(v) for v in s.split("/")] for s in args.sizes.split(",")]
    trees = [str(Path(t).resolve()) for t in args.trees]
    runs = {t: [] for t in args.trees}
    with tempfile.TemporaryDirectory() as keep:
        for i in range(args.rounds):
            for name, tree in zip([*args.trees, *reversed(args.trees)],
                                  [*trees, *reversed(trees)]):
                kept = Path(keep) / str(args.trees.index(name))
                kept.mkdir(exist_ok=True)
                proc = subprocess.run(
                    [sys.executable, "-c", RUN, tree, json.dumps(sizes), str(args.frames),
                     str(args.iters), str(args.seed), args.dtype,
                     str(kept) if i == 0 and not runs[name] else ""],
                    capture_output=True, text=True, timeout=1800)
                if proc.returncode != 0:
                    raise SystemExit(f"ab_b1_sizes: the run of {name} failed:\n"
                                     f"{proc.stderr[-3000:]}")
                runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        first = [runs[name][0] for name in args.trees]
        # a size whose check failed in a run is timed all the same, and named
        # here; the tool then exits 1
        failed = {name: {size: msg for r in rs for size, msg in r["failed"].items()}
                  for name, rs in runs.items()}
        failed = {name: sizes for name, sizes in failed.items() if sizes}
        bit_equal = {size: first[0]["sha256"][size] == first[1]["sha256"][size]
                     for size in first[0]["sha256"]}
        differ = {}
        for size, same in bit_equal.items():
            if not same:
                name = "-".join(size.split("/")[:2]) + "-" + (
                    size.split("/")[2] if size.count("/") == 2 else str(args.frames))
                a, b = (np.load(Path(keep) / str(t) / f"{name}.npy") for t in (0, 1))
                differ[size] = float(np.abs(a - b).max())
    print(json.dumps({"frames": args.frames, "dtype": args.dtype, "order": "A B B A",
                      "ms": {name: {size: [r["ms"][size] for r in rs] for size in rs[0]["ms"]}
                             for name, rs in runs.items()},
                      "bit_equal": bit_equal, "max_abs_diff_first_64_frames": differ,
                      "failed": failed}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
