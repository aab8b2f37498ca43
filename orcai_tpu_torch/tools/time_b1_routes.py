"""Warm `predict` walls on a spectral wire with B1 on its mixed route and on
its GEMM route, in turns, on a CUDA device.

    python -m orcai_tpu_torch.tools.time_b1_routes [--wire sp-bfp5] [--repeats 9] [--seed 0]

Takes the 20-minute cell of chip_smoke.py (a 48 kHz int16 recording
synthesized from --seed, the bundled orcai-v1 in float32 at batch 128) and
runs `predict` on --wire in memory and streamed (ORCAI_TPU_STREAM_SPEC_BYTES=1,
the audio resident). Each is timed --repeats times with B1 on the route
ops/dft.py::dft_route gives the wire's n_fft (the mixed-radix FFT at 384 and
352) and as many with B1 sent to the GEMM route (csrc/dft_gemm.cu, which
took these sizes before the mixed route existed), in turns (mixed, gemm,
gemm, mixed, ...), each run ended by a synchronize. Prints one JSON line per
path with every wall, the medians, the launches by route of one run and
whether the two routes' TSVs are byte-equal, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

MINUTES = 20.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--wire", default="sp-bfp5")
    parser.add_argument("--repeats", type=int, default=9)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from orcai_tpu_torch.io.model_store import load_orcai_model
    from orcai_tpu_torch.ops import dft
    from orcai_tpu_torch.ops.overlap import WindowPredictor
    from orcai_tpu_torch.pipeline.predict import predict
    from orcai_tpu_torch.tools.synthetic import synth_sweep_wav
    from orcai_tpu_torch.utils.device import exact_f32_math

    if not torch.cuda.is_available():
        raise SystemExit("time_b1_routes: no CUDA device")
    route_of = dft.dft_route

    def gemm_route(n_fft: int) -> str:
        return "gemm" if route_of(n_fft) == "mixed" else route_of(n_fft)

    with tempfile.TemporaryDirectory() as tmp, exact_f32_math():
        tmp = Path(tmp)
        wav = tmp / "synthetic_20min.wav"
        synth_sweep_wav(wav, args.seed, MINUTES)
        model, param, shape = load_orcai_model(device="cuda")
        predictor = WindowPredictor(model, snippet_len=shape["input_shape"][0],
                                    n_filters=len(param["model"]["filters"]), batch_size=128)

        def run(path: str, route: str) -> tuple[float, Path]:
            out = tmp / f"{path}_{route}.txt"
            dft.dft_route = route_of if route == "mixed" else gemm_route
            env = {"ORCAI_TPU_STREAM_SPEC_BYTES": "1"} if path == "streamed" else {}
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                predict(wav, output_path=out, overwrite=True, predictor=predictor,
                        wire=args.wire)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, out
            finally:
                dft.dft_route = route_of
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v

        for path in ("in_memory", "streamed"):
            launches = {}
            for route in ("mixed", "gemm"):  # warm, and one run's launches
                dft.dft_magnitude.route_launches = dict.fromkeys(dft.ROUTES, 0)
                run(path, route)
                launches[route] = dict(dft.dft_magnitude.route_launches)
            walls = {"mixed": [], "gemm": []}
            outs = {}
            for i in range(args.repeats):
                for route in (("mixed", "gemm") if i % 2 == 0 else ("gemm", "mixed")):
                    wall, outs[route] = run(path, route)
                    walls[route].append(wall)
            print(json.dumps({
                "path": path, "wire": args.wire, "minutes": MINUTES, "walls_s": walls,
                "median_s": {k: statistics.median(v) for k, v in walls.items()},
                "launches_by_route": launches,
                "tsv_byte_equal": outs["mixed"].read_bytes() == outs["gemm"].read_bytes(),
            }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
