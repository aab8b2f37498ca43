"""Command line: python -m orcai_tpu_torch <command> [options].

The commands and flags follow `orcai predict`, `orcai filter-predictions`,
`orcai serve`, `orcai warmup`, `orcai train`, `orcai test`, `orcai
hpsearch` and the data preparation commands `orcai init`,
`create-recording-table`, `create-spectrograms`, `create-label-arrays`,
`create-snippet-table`, `create-tvt-snippet-tables`, `create-tvt-data` and
`convert-dataset` (orcai_tpu/cli.py), with the same options, plus
`--device`. Every command that computes on a device runs on `--device cuda`
unless told otherwise, and raises without CUDA; the table, label and
dataset steps run on the host, as in the reference. Each command reports
on the console through a Messenger titled as the reference's
(utils/messenger.py), at --verbosity 0-3. Started once per process by a
launcher (WORLD_SIZE > 1, with RANK, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT), a command joins the launcher's process group first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _common(p: argparse.ArgumentParser, device: bool = True) -> None:
    p.add_argument("--verbosity", "-v", type=int, choices=range(4), default=2,
                   help="0: errors only, 1: warnings, 2: info (default), 3: debug")
    if device:
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")


def _model_options(p: argparse.ArgumentParser, models: list[str]) -> None:
    """--model and --model_dir, of `predict`, `serve` and `warmup`."""
    p.add_argument("--model", "-m", default="orcai-v1", choices=models or None,
                   type=str.lower if models else str,
                   help="bundled model to use; overridden by --model_dir "
                        "(default: orcai-v1)")
    p.add_argument("--model_dir", "-md", default=None,
                   help="path to a model directory (default: the bundled --model)")


def _wire_option(p: argparse.ArgumentParser, text: str) -> None:
    from orcai_tpu_torch.ops.wire_names import WIRE_CODECS

    p.add_argument("--wire_codec", "-wc", dest="wire", default="auto",
                   choices=["auto", *WIRE_CODECS], help=text)


_WIRE_HELP = (
    "Host->device audio byte format: exact PCM; 8-bit mu-law codes (1 "
    "byte/sample, 38 dB SNR); packed block-floating-point (bfp6 0.76 "
    "bytes/sample ~33 dB, bfp5 0.63 ~27 dB) decoded on device; or the "
    "spectral wires (sp-bfp6 0.57, sp-bfp5 0.47, sp11-bfp5 0.44) - a host "
    "3/4 (sp11: 11/16) resample that drops only the band the frontend "
    "crops, then the base codec. All hold annotation-level parity. auto = "
    "ORCAI_TPU_WIRE if set, else exact (the reference's auto gives sp-bfp5 "
    "on a TPU only) (default: auto)"
)


def _predict_options(p: argparse.ArgumentParser, models: list[str]) -> None:
    """The options `predict` and `serve` share."""
    p.add_argument("--channel", "-c", type=int, default=1,
                   help="channel to use for prediction (default: 1)")
    _model_options(p, models)
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="overwrite existing predictions")
    p.add_argument("--save_probabilities", "-sp", action="store_true",
                   help="save prediction probabilities beside each TSV")
    p.add_argument("--call_duration_limits", "-cdl", default=None,
                   help="JSON file with call duration limits (default: no filtering)")
    p.add_argument("--label_suffix", "-ls", default="*",
                   help="suffix to add to the label names (default: *)")
    p.add_argument("--predict_batch_size", "-bs", type=int, default=128,
                   help="window batch size for on-device inference (default: 128)")


def _parser() -> argparse.ArgumentParser:
    from orcai_tpu_torch import __version__
    from orcai_tpu_torch.io.model_store import bundled_models
    from orcai_tpu_torch.resources import (
        DEFAULT_CALL_DURATION_LIMITS,
        DEFAULT_HPS_PARAMETER,
        DEFAULT_ORCAI_PARAMETER,
    )

    models = bundled_models()
    parser = argparse.ArgumentParser(
        prog="python -m orcai_tpu_torch", description="orcAI on PyTorch/CUDA"
    )
    parser.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name: str, text: str) -> argparse.ArgumentParser:
        return sub.add_parser(name, help=text, description=text)

    p = command(
        "predict",
        "Predicts call annotations in a wav file or in every row of a "
        "recording table (.csv).",
    )
    p.add_argument("recording_path", help="path to a .wav recording or a .csv table")
    _predict_options(p, models)
    p.add_argument("--output_path", "-o", default="default",
                   help="output file (folder for a table), or 'default' to save "
                        "next to the wav")
    p.add_argument("--base_dir_recording", "-bdr", default=None,
                   help="alternative base directory containing the recordings")
    _wire_option(p, _WIRE_HELP)
    _common(p)

    p = command(
        "serve",
        "Watches WATCH_DIR for new wav recordings and predicts each as it "
        "arrives, holding one model for the life of the process. Failures "
        "leave a .failed marker and the service keeps running.",
    )
    p.add_argument("watch_dir", help="directory to watch for .wav files")
    _predict_options(p, models)
    _wire_option(p, "host->device audio byte format (see predict; default: auto)")
    p.add_argument("--output_dir", "-o", default=None,
                   help="directory for the prediction TSVs (default: next to each wav)")
    p.add_argument("--poll_seconds", "-ps", type=float, default=2.0,
                   help="directory poll interval (default: 2)")
    p.add_argument("--warm_minutes", "-wm", type=float, default=0.0,
                   help="run every recording-length shape up to this duration "
                        "before serving (default: 0)")
    p.add_argument("--max_files", "-mf", type=int, default=None,
                   help="stop after processing this many recordings")
    _common(p)

    p = command(
        "warmup",
        "Builds the kernels and runs the predict path once for every "
        "recording-length shape up to --minutes.",
    )
    p.add_argument("--minutes", "-mi", type=float, default=90.0,
                   help="longest recording duration to cover (default: 90)")
    _model_options(p, models)
    p.add_argument("--predict_batch_size", "-bs", type=int, default=128,
                   help="window batch size (default: 128)")
    _wire_option(p, "wire codec to warm (must match production predicts; the "
                    "frontends differ per codec; default: auto)")
    _common(p)

    def data_compression(p: argparse.ArgumentParser, text: str, auto: bool = False) -> None:
        # "None" on the command line is None in the call; case is ignored
        p.add_argument("--data_compression", "-dc", default="auto" if auto else "None",
                       type=lambda v: {"gzip": "GZIP", "none": None}.get(v.lower(), v.lower()),
                       choices=["GZIP", None, "auto"] if auto else ["GZIP", None], help=text)

    reading = ("compression the datasets were written with (default: None; the "
               "dataset's meta.json decides on load)")

    p = command(
        "train",
        "Trains a model on the training dataset in DATA_DIR and saves it to "
        "OUTPUT_DIR.",
    )
    p.add_argument("data_dir", help="directory with train_dataset and val_dataset")
    p.add_argument("output_dir", help="directory the model directory is written into")
    p.add_argument("--orcai_parameter", "-p", default=str(DEFAULT_ORCAI_PARAMETER),
                   help="path to the orcAI parameter file "
                        "(default: default_orcai_parameter.json)")
    data_compression(p, reading)
    p.add_argument("--load_model", "-lm", action="store_true",
                   help="load model from previous training")
    _common(p)

    p = command(
        "test",
        "Tests a model at MODEL_DIR on the test dataset in DATA_DIR and saves "
        "the results to OUTPUT_DIR.",
    )
    p.add_argument("model_dir", help="path to a model directory")
    p.add_argument("data_dir", help="directory with test_dataset")
    p.add_argument("--test_unfiltered", "-tu", action="store_true",
                   help="also test on the unfiltered test dataset")
    p.add_argument("--output_dir", "-o", default=None,
                   help="output directory (default: <model_dir>/test)")
    data_compression(p, reading)
    _common(p)

    p = command(
        "hpsearch",
        "Performs hyperparameter search on the training dataset in DATA_DIR "
        "and saves the results to OUTPUT_DIR.",
    )
    p.add_argument("data_dir", help="directory with train_dataset and val_dataset")
    p.add_argument("output_dir", help="directory hps_logs and the best model are written into")
    p.add_argument("--orcai_parameter", "-p", default=str(DEFAULT_ORCAI_PARAMETER),
                   help="path to the orcAI parameter file "
                        "(default: default_orcai_parameter.json)")
    p.add_argument("--hps_parameter", "-hp", default=str(DEFAULT_HPS_PARAMETER),
                   help="path to the hyperparameter search parameter file "
                        "(default: default_hps_parameter.json)")
    p.add_argument("--parallel", "-pl", action="store_true",
                   help="run a rung's trials side by side, one per visible CUDA device")
    data_compression(p, reading)
    _common(p)

    p = command("init", "Initializes a new orcAI project with PROJECT_NAME in PROJECT_DIR.")
    p.add_argument("project_dir", help="project directory (created if missing)")
    p.add_argument("project_name", help="project name")
    p.add_argument("--parameter", "-p", default=None,
                   help="JSON file with orcAI parameter overrides")
    _common(p, device=False)

    p = command(
        "create-recording-table",
        "Create a table of recordings in BASE_DIR_RECORDING for use with other "
        "orcAI functions.",
    )
    p.add_argument("base_dir_recording", help="directory scanned for .wav files")
    p.add_argument("--output_path", "-o", default=None,
                   help="path to save the table (default: "
                        "BASE_DIR_RECORDING/recording_table.csv)")
    p.add_argument("--base_dir_annotation", "-bda", default=None,
                   help="base directory containing the annotations")
    p.add_argument("--default_channel", "-dc", type=int, default=1,
                   help="default channel number (default: 1)")
    p.add_argument("--orcai_parameter", "-p", default=None,
                   help="path to the orcAI parameter file (its calls become columns)")
    p.add_argument("--update_table", "-ut", default=None,
                   help="previous recording table to update")
    p.add_argument("--update_paths", "-up", action="store_true",
                   help="update paths from the new scan when updating a table")
    p.add_argument("--exclude_patterns", "-ep", default=None,
                   help="JSON file with filename patterns to exclude")
    p.add_argument("--remove_duplicate_filenames", "-rdf", action="store_true",
                   help="remove duplicate filenames from the table")
    _common(p, device=False)

    def parameter(p: argparse.ArgumentParser) -> None:
        p.add_argument("--orcai_parameter", "-p", default=str(DEFAULT_ORCAI_PARAMETER),
                       help="path to the orcAI parameter file "
                            "(default: default_orcai_parameter.json)")

    p = command(
        "create-spectrograms",
        "Creates spectrograms for all files in recording table at "
        "RECORDING_TABLE_PATH and writes them to OUTPUT_DIR.",
    )
    p.add_argument("recording_table_path", help="recording table (.csv)")
    p.add_argument("output_dir", help="directory the recording data is written into")
    p.add_argument("--base_dir_recording", "-bdr", default=None,
                   help="base directory for the wav files")
    parameter(p)
    p.add_argument("--include_not_annotated", "-en", action="store_true",
                   help="include recordings without annotations")
    p.add_argument("--include_no_possible_annotations", "-enp", action="store_true",
                   help="include recordings without possible annotations")
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="recreate existing spectrograms")
    _common(p)

    p = command(
        "create-label-arrays",
        "Creates label arrays for all files in recording table at "
        "RECORDING_TABLE_PATH and writes them to OUTPUT_DIR.",
    )
    p.add_argument("recording_table_path", help="recording table (.csv)")
    p.add_argument("output_dir", help="directory with the recording data")
    p.add_argument("--base_dir_annotation", "-bda", default=None,
                   help="base directory for the annotation files")
    parameter(p)
    p.add_argument("--call_equivalences", "-ce", default=None,
                   help="JSON mapping original call labels to new call labels")
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="recreate existing label arrays")
    _common(p, device=False)

    p = command(
        "create-snippet-table",
        "Creates a table of snippets for all files in recording table at "
        "RECORDING_TABLE_PATH using data in RECORDING_DATA_DIR.",
    )
    p.add_argument("recording_table_path", help="recording table (.csv)")
    p.add_argument("recording_data_dir", help="directory with the recording data")
    p.add_argument("--output_dir", "-o", default=None,
                   help="output directory (default: tvt_data next to the recording table)")
    parameter(p)
    _common(p, device=False)

    p = command(
        "create-tvt-snippet-tables",
        "Creates snippet tables for training, validation and test datasets and "
        "saves them to OUTPUT_DIR.",
    )
    p.add_argument("output_dir", help="directory of the snippet tables")
    p.add_argument("--snippet_table", "-st", default=None,
                   help="snippet table csv (default: OUTPUT_DIR/all_snippets.csv.gz)")
    parameter(p)
    p.add_argument("--create_unfiltered_test_snippets", "-uts", action="store_true",
                   help="also create an unfiltered test snippet table")
    p.add_argument("--n_unfiltered_test_snippets", "-n_uts", type=int, default=None,
                   help="number of unfiltered test snippets")
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="overwrite existing snippet tables")
    _common(p, device=False)

    p = command(
        "create-tvt-data",
        "Creates training, validation and test datasets from snippet tables in TVT_DIR.",
    )
    p.add_argument("tvt_dir", help="directory of the snippet tables")
    parameter(p)
    p.add_argument("--overwrite", "-ow", action="store_true", help="recreate existing data")
    data_compression(p, "data compression for the datasets (default: None keeps the "
                        "shards memory-mappable)")
    _common(p, device=False)

    p = command(
        "convert-dataset",
        "Converts reference-materialized tf.data dataset snapshots "
        "({train,val,test[,test_unfiltered]}_dataset dirs under TVT_DIR, as "
        "written by upstream orcAI's create-tvt-data) into ArrayDataset "
        "shards, in place by default; afterwards `train` and `test` run on "
        "TVT_DIR directly. Reads the snapshot files themselves: no "
        "TensorFlow is needed.",
    )
    p.add_argument("tvt_dir", help="directory holding the *_dataset snapshot dirs")
    p.add_argument("--output_dir", "-o", default=None,
                   help="write converted datasets here instead of in place")
    data_compression(p, "compression the snapshots were saved with (reference default "
                        "GZIP); auto probes (default: auto)", auto=True)
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="redo datasets that were already converted")
    _common(p, device=False)

    p = command(
        "filter-predictions",
        "Filters the predictions file at PREDICTED_LABELS by call duration.",
    )
    p.add_argument("predicted_labels", help="path to a predictions TSV")
    p.add_argument("--call_duration_limits", "-cdl",
                   default=str(DEFAULT_CALL_DURATION_LIMITS),
                   help="JSON file with call duration limits "
                        "(default: default_call_duration_limits.json)")
    p.add_argument("--output_file", "-o", default="default",
                   help="output file, or 'default' to save next to the predictions")
    p.add_argument("--overwrite", "-ow", action="store_true",
                   help="overwrite existing predictions")
    p.add_argument("--label_suffix", "-ls", default="*",
                   help="suffix that was added to the label names (default: *)")
    _common(p, device=False)
    return parser


# path arguments made absolute, as the reference's click paths are (they end
# up in the tables the commands write and in the console report); predict's
# --output_path and filter-predictions' --output_file are plain text there
_PATHS = {
    "project_dir", "parameter", "base_dir_recording", "output_path", "base_dir_annotation",
    "orcai_parameter", "update_table", "exclude_patterns", "recording_table_path",
    "output_dir", "call_equivalences", "recording_data_dir", "snippet_table", "tvt_dir",
    "recording_path", "model_dir", "call_duration_limits", "watch_dir", "predicted_labels",
    "data_dir", "hps_parameter",
}

# each command's console report title (orcai_tpu/cli.py)
_TITLES = {
    "predict": "Predicting calls", "serve": "Serving predictions",
    "warmup": "Warming predict executables", "filter-predictions": "Filtering predictions",
    "init": "Initializing project", "create-recording-table": "Creating recording table",
    "create-spectrograms": "Creating spectrograms",
    "create-label-arrays": "Creating label arrays",
    "create-snippet-table": "Creating snippet table",
    "create-tvt-snippet-tables": "Creating train, validation and test snippet tables",
    "create-tvt-data": "Creating train, validation and test datasets",
    "convert-dataset": "Converting tf.data datasets", "train": "Training model",
    "hpsearch": "Hyperparameter search",
}


def main(argv=None) -> int:
    from orcai_tpu_torch.utils.messenger import Messenger

    args = vars(_parser().parse_args(argv))
    command = args.pop("command")
    plain_text = {"predict": "output_path", "filter-predictions": "output_file"}.get(command)
    for key in _PATHS & args.keys() - {plain_text}:
        if args[key] is not None:
            args[key] = str(Path(args[key]).resolve())
    verbosity = args["verbosity"]
    title = (f"Testing model {Path(args['model_dir']).name}" if command == "test"
             else _TITLES[command])
    # started by a launcher once per process (torchrun and the like): join
    # its group; the batch commands then split their work over it
    from orcai_tpu_torch.parallel.distributed import join_launched_group

    join_launched_group()
    if "model" in args:  # predict, serve, warmup: --model_dir wins over --model
        from orcai_tpu_torch.io.model_store import MODELS_DATA_DIR

        model = args.pop("model")
        if args["model_dir"] is None:
            args["model_dir"] = str(MODELS_DATA_DIR / model)
    msgr = Messenger(verbosity=verbosity, title=title)
    args["msgr"] = msgr

    if command == "predict":
        from orcai_tpu_torch.pipeline.predict import predict

        predict(**args)
    elif command == "serve":
        from orcai_tpu_torch.pipeline.serve import serve

        serve(**args)
    elif command == "warmup":
        from orcai_tpu_torch.tools.warmup import warmup

        n = warmup(args["minutes"], args["model_dir"], args["predict_batch_size"],
                   device=args["device"], wire=args["wire"], msgr=msgr)
        msgr.part(f"Warmed {n} recording-length executables")
    elif command == "train":
        from orcai_tpu_torch.train.trainer import train

        train(**args)
    elif command == "hpsearch":
        from orcai_tpu_torch.train.hpsearch import hyperparameter_search

        hyperparameter_search(**args)
    elif command == "test":
        from orcai_tpu_torch.train.evaluate import test_model

        test_model(**args)
    elif command == "init":
        from orcai_tpu_torch.pipeline.helpers import init_project

        init_project(**args)
    elif command == "create-recording-table":
        from orcai_tpu_torch.pipeline.helpers import create_recording_table

        create_recording_table(**args)
    elif command == "create-spectrograms":
        from orcai_tpu_torch.pipeline.spectrogram import create_spectrograms

        create_spectrograms(**args)
    elif command == "create-label-arrays":
        from orcai_tpu_torch.pipeline.labels import create_label_arrays

        create_label_arrays(**args)
    elif command == "create-snippet-table":
        from orcai_tpu_torch.pipeline.snippets import create_snippet_table

        create_snippet_table(**args)
    elif command == "create-tvt-snippet-tables":
        from orcai_tpu_torch.pipeline.snippets import create_tvt_snippet_tables

        create_tvt_snippet_tables(**args)
    elif command == "create-tvt-data":
        from orcai_tpu_torch.pipeline.snippets import create_tvt_data

        create_tvt_data(**args)
    elif command == "convert-dataset":
        from orcai_tpu_torch.io.tfdata_convert import convert_tvt_datasets

        converted = convert_tvt_datasets(
            args["tvt_dir"], output_dir=args["output_dir"], overwrite=args["overwrite"],
            compression=args["data_compression"], msgr=msgr,
        )
        if converted:
            msgr.part("Converted "
                      + ", ".join(f"{k} ({v} samples)" for k, v in converted.items()))
        else:
            msgr.part("Nothing to convert (all splits already converted)")
    else:
        from orcai_tpu_torch.pipeline.predict import filter_predictions_file

        filter_predictions_file(**args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
