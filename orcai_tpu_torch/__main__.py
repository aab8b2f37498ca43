"""Command line: python -m orcai_tpu_torch predict <wav> [options].

The flags follow `orcai predict` (orcai_tpu/cli.py) for a single wav file.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m orcai_tpu_torch",
        description="orcAI on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("predict", help="Predicts call annotations in a wav file.")
    p.add_argument("recording_path", help="path to a .wav recording")
    p.add_argument("--channel", "-c", type=int, default=1,
                   help="channel to use for prediction (default: 1)")
    p.add_argument("--model_dir", "-md", default=None,
                   help="path to a model directory (default: bundled orcai-v1)")
    p.add_argument("--output_path", "-o", default="default",
                   help="output file, or 'default' to save next to the wav")
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="overwrite existing predictions")
    p.add_argument("--label_suffix", "-ls", default="*",
                   help="suffix to add to the label names (default: *)")
    p.add_argument("--predict_batch_size", "-bs", type=int, default=128,
                   help="window batch size for on-device inference (default: 128)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from orcai_tpu_torch.pipeline.predict import predict

    out = predict(
        args.recording_path,
        channel=args.channel,
        model_dir=args.model_dir,
        output_path=args.output_path,
        overwrite=args.overwrite,
        label_suffix=args.label_suffix,
        predict_batch_size=args.predict_batch_size,
        device=args.device,
    )
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
