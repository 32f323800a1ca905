"""Dataset factory entry point of the port (JAX: dataset_process.py at the
repository root; reference: src/dataset/processes/*.py):

    python -m dualdiffusion_tpu_torch.dataset_process <process> --dataset_path <dir> \
        [--model_path <model>] [--device cuda|cpu] [...]

Processes: ``import`` (``--input <src_dir>``), ``normalize``, ``encode``
(``--model_path``), ``label``, ``dedupe``, ``build_splits``,
``build_emb_db``, ``aggregate_embeddings`` (``--copy_to_model_path``) and
``integrity_check``. ``encode`` runs its model in a spawned worker on
``--device``: the card by default; without one it raises unless
``--device cpu`` is given, and it never falls back to the CPU. The process
exits with 1 when any stage logged an error.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from typing import Optional, Sequence

PROCESSES = ("import", "normalize", "encode", "label", "dedupe", "build_splits",
             "build_emb_db", "aggregate_embeddings", "integrity_check")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dualdiffusion_tpu_torch.dataset_process")
    ap.add_argument("process", choices=PROCESSES)
    ap.add_argument("--copy_to_model_path", default=None,
                    help="for aggregate_embeddings: also copy the table into this model dir "
                         "so the pipeline picks it up")
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--input", default=None, help="input path override")
    ap.add_argument("--model_path", default=None, help="for encode")
    ap.add_argument("--device", default="cuda",
                    help="for encode (and label's CLAP): cuda (default) or cpu")
    ap.add_argument("--target_lufs", type=float, default=-20.0)
    ap.add_argument("--max_num_proc", type=int, default=None)
    ap.add_argument("--force_overwrite", action="store_true")
    ap.add_argument("--test_mode", action="store_true")
    ap.add_argument("--validation_fraction", type=float, default=0.02)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one process; returns 1 when any stage logged an error, else 0."""
    args = parse_args(argv)
    from .dataset import DatasetProcessor, DatasetProcessorConfig
    from .dataset import processes as P

    proc = DatasetProcessor(DatasetProcessorConfig(
        dataset_path=args.dataset_path, max_num_proc=args.max_num_proc,
        force_overwrite=args.force_overwrite, test_mode=args.test_mode))
    scan = [args.input or args.dataset_path]
    infos = os.path.join(args.dataset_path, "dataset_infos")

    if args.process == "import":
        if not args.input:
            raise ValueError("import requires --input")
        out = proc.process("Import", [P.ImportStage(args.dataset_path)], input=[args.input],
                           input_extensions=P.AUDIO_EXTS)
    elif args.process == "normalize":
        out = proc.process("Normalize", [P.NormalizeStage(args.target_lufs)], input=scan,
                           input_extensions=P.AUDIO_EXTS)
    elif args.process == "encode":
        if not args.model_path:
            raise ValueError("encode requires --model_path")
        import torch
        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to encode on the CPU")
        enc = P.EncodeConfig(model_path=args.model_path, device=args.device)
        out = proc.process("Encode", [P.EncodeLoadStage(enc), P.EncodeStage(enc),
                                      P.EncodeSaveStage(enc)],
                           input=scan, input_extensions=P.AUDIO_EXTS)
    elif args.process == "dedupe":
        out = proc.process("Dedupe", [P.DedupeStage(os.path.join(infos,
                                                                 "audio_emb_db.safetensors"))],
                           input=scan, input_extensions=P.AUDIO_EXTS)
    elif args.process == "label":
        from .models.embeddings import CLAPEmbedding
        from .utils import load_json
        labels = load_json(os.path.join(infos, "labels.json"))["labels"]
        clap = CLAPEmbedding(device=args.device)
        out = proc.process("Label", [P.LabelStage(dict(zip(labels, clap.encode_text(labels))))],
                           input=scan, input_extensions=P.AUDIO_EXTS)
    elif args.process == "build_splits":
        out = proc.process("BuildSplits", [P.BuildSplitsStage()], input=scan,
                           input_extensions=P.AUDIO_EXTS, collect_results=True)
        P.BuildSplitsStage.write_jsonl(out["results"], args.dataset_path,
                                       args.validation_fraction)
        print(f"wrote {len(out['results'])} records to train/validation.jsonl")
    elif args.process == "build_emb_db":
        out = proc.process("BuildEmbDB", [P.BuildEmbDBStage()], input=scan,
                           input_extensions=P.AUDIO_EXTS, collect_results=True)
        os.makedirs(infos, exist_ok=True)
        P.BuildEmbDBStage.write_db(out["results"],
                                   os.path.join(infos, "audio_emb_db.safetensors"))
        print(f"wrote {len(out['results'])} embeddings to audio_emb_db")
    elif args.process == "aggregate_embeddings":
        out = proc.process("AggregateEmbeddings", [P.AggregateEmbeddingsStage()], input=scan,
                           input_extensions=P.AUDIO_EXTS, collect_results=True)
        os.makedirs(infos, exist_ok=True)
        db = os.path.join(infos, "dataset_embeddings.safetensors")
        P.AggregateEmbeddingsStage.write_db(out["results"], db)
        print(f"aggregated {len(out['results'])} samples into {db}")
        if args.copy_to_model_path:
            dst = os.path.join(args.copy_to_model_path, "dataset_embeddings.safetensors")
            shutil.copy2(db, dst)
            print(f"copied to {dst}")
    else:  # integrity_check
        out = proc.process("IntegrityCheck", [P.IntegrityCheckStage()], input=scan,
                           input_extensions=P.AUDIO_EXTS)
    return 1 if out["errors"] else 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(main())
