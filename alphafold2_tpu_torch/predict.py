"""Inference entry point: amino-acid sequence -> CA trace -> PDB, or with
--full-atom the whole structure pipeline -> N/CA/C/O PDB, on the port
(counterpart of predict.py).

Usage:
  python -m alphafold2_tpu_torch.predict --seq ACDEFGHIKLMNPQRSTVWY --out s.pdb
  python -m alphafold2_tpu_torch.predict --seq ... --msa-file aln.a3m --bf16
  python -m alphafold2_tpu_torch.predict --seq ... --device cpu
  python -m alphafold2_tpu_torch.predict --seq ... --bf16 --weight-dtype int8
  python -m alphafold2_tpu_torch.predict --seq ... --sp-shards 4
  python -m alphafold2_tpu_torch.predict --seq ... --templates-file t.npz
  python -m alphafold2_tpu_torch.predict --seq ... --embedds-file e.npz
  python -m alphafold2_tpu_torch.predict --seq ... --ckpt-dir runs/pre --depth 1 \
      --max-seq-len 2048 --bf16
  python -m alphafold2_tpu_torch.predict --seq ... --full-atom [--embedds-file e.npz]
  python -m alphafold2_tpu_torch.predict --seq ... --trace-out trace.json

Parameters come from `--ckpt-dir` (the newest verified checkpoint there,
`training/checkpoint.py`, written by either package's `train_pre`; the
model flags must match the run that wrote it, `--max-seq-len 2048` for
`train_pre`'s tables), or else from `--seed` through the port's own init.
A checkpoint holds f32 master weights: `--weight-dtype int8` quantizes
them as it serves them, through `serving/quant_residency.py
resident_params`, as the JAX serving engine does. Runs on the GPU unless
`--device cpu` is given; float32 matmuls and convolutions run in full
float32 there (TF32 off). `--sp-shards N` runs the trunk sequence-parallel
(parallel/sp_trunk.py alphafold2_apply_sp) over N distinct cards, so it
needs N of them, as the JAX CLI needs N devices; with `--device cpu` the N
shards run on the CPU. `--templates-file` (templates through the template
tower) and `--embedds-file` (precomputed residue embeddings in place of
an MSA) read the JAX CLI's .npz files and check them as it does.

--full-atom runs `training/e2e.py predict_structure` (the trunk on the x3
elongated sequence, one token per backbone atom -> distogram -> MDS with
the mirror fix -> the side-chain lift -> the refiner of depth
--refiner-depth) on parameters of the end-to-end tree {"model",
"refiner"} (a JAX or port end-to-end checkpoint with --ckpt-dir), and
writes the refined N/CA/C/O atoms with the mean of each residue's three
per-atom confidences as B-factors. Its embeddings file is per residue and
is elongated x3 here, and its templates file is over the 3L grid. With
--sp-shards N the 3L grid must divide by N, as in the JAX CLI: padding
would change the structure, since the trunk's pair mask (mask_i | mask_j,
the reference's) lets pad keys into every real row. int8 weights
with --full-atom are refused (ROADMAP A8-e2e-int8): the JAX full-atom CLI
has no int8 arm.

`--trace-out` writes the run's spans as a Chrome trace (`predict.forward`,
which closes after the outputs reach the host, and `predict.write_pdb`),
also when the prediction fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from alphafold2_tpu_torch.constants import aa_to_tokens
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.geometry.distogram import distogram_confidence
from alphafold2_tpu_torch.geometry.pdb import coords_to_pdb
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.telemetry import add_telemetry_args, finish_trace, tracer_from_args
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.models.refiner import RefinerConfig
from alphafold2_tpu_torch.parallel import alphafold2_apply_sp, make_mesh
from alphafold2_tpu_torch.serving.pipeline import predict_structure
from alphafold2_tpu_torch.serving.quant_residency import resident_params
from alphafold2_tpu_torch.training import e2e
from alphafold2_tpu_torch.training.checkpoint import restore_params_for_inference


def load_embedds(ap, args, L):
    """--embedds-file's (1, L, num_embedds) float32 array, or None; the JAX
    CLI's checks and messages (an argparse error)."""
    if args.embedds_file is None:
        return None
    if args.msa_file is not None:
        ap.error("--embedds-file and --msa-file are exclusive (the "
                 "embedds path is the MSA substitute)")
    if args.sp_shards:
        ap.error("--embedds-file is unsupported with --sp-shards (the "
                 "substitute stream has no row axis to shard)")
    raw = np.load(args.embedds_file)
    arr = raw["embedds"] if hasattr(raw, "files") else raw
    if arr.ndim == 2:
        arr = arr[None]
    if arr.shape[1] != L:
        ap.error(f"--embedds-file has {arr.shape[1]} residues; --seq has {L}")
    embedds = np.asarray(arr, np.float32)
    print(f"embedds: {embedds.shape[1]} residues x {embedds.shape[2]} dims from "
          f"{args.embedds_file}")
    return embedds


def load_templates(ap, path, L, full_atom=False):
    """--templates-file's (templates, templates_mask), or (None, None): int
    arrays are distogram buckets (checked to lie in [0, 37)), float arrays
    raw distances the model buckets itself, so each keeps its kind; the
    mask defaults to all-true. The pair grid is L x L, or with full_atom
    the elongated 3L x 3L. The JAX CLI's checks and messages (an argparse
    error)."""
    if path is None:
        return None, None
    raw = np.load(path)
    tarr = np.asarray(raw["templates"])
    if np.issubdtype(tarr.dtype, np.integer):
        if tarr.min() < 0 or tarr.max() >= 37:
            ap.error(f"--templates-file int buckets must be in [0, 37); "
                     f"got range [{tarr.min()}, {tarr.max()}] — pass "
                     f"float distances to have the model bin them")
        templates = tarr.astype(np.int32)
    else:
        templates = tarr.astype(np.float32)
    if templates.ndim == 3:
        templates = templates[None]
    templates_mask = (np.asarray(raw["templates_mask"], bool)
                      if "templates_mask" in getattr(raw, "files", ())
                      else np.ones(templates.shape, bool))
    if templates_mask.ndim == 3:
        templates_mask = templates_mask[None]
    if templates_mask.shape != templates.shape:
        ap.error(f"--templates-file 'templates_mask' shape "
                 f"{tuple(templates_mask.shape)} does not match "
                 f"'templates' shape {tuple(templates.shape)}")
    grid = 3 * L if full_atom else L
    if templates.shape[-2:] != (grid, grid):
        ap.error(f"--templates-file pair grid is "
                 f"{templates.shape[-2]}x{templates.shape[-1]}; the "
                 f"model's is {grid}x{grid} "
                 f"({'3L, elongated' if full_atom else 'L'})")
    print(f"templates: {templates.shape[1]} x {templates.shape[-1]}^2 grids from {path}")
    return templates, templates_mask


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True, help="one-letter amino-acid sequence")
    ap.add_argument("--out", default="prediction.pdb")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dim-head", type=int, default=64)
    ap.add_argument("--mds-iters", type=int, default=200)
    ap.add_argument("--mds-init", choices=("random", "classical"), default="classical")
    ap.add_argument("--msa-file", default=None,
                    help="FASTA/A3M alignment for the MSA track (first record "
                         "= query; rows capped at --max-msa-rows)")
    ap.add_argument("--max-msa-rows", type=int, default=20)
    ap.add_argument("--max-num-msa", type=int, default=None,
                    help="MSA row-position-table size (default: from the "
                         "loaded MSA, min 20)")
    ap.add_argument("--embedds-file", default=None,
                    help=".npz with 'embedds' (1, L, 1280) or (L, 1280): "
                         "precomputed residue embeddings as the MSA substitute; "
                         "exclusive with --msa-file and --sp-shards")
    ap.add_argument("--templates-file", default=None,
                    help=".npz with 'templates' (1, T, L, L) int distogram buckets "
                         "in [0, 37) or float distances in Angstroms, and an "
                         "optional 'templates_mask' (1, T, L, L) bool")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--weight-dtype", choices=("f32", "int8"), default="f32",
                    help="int8: serve per-channel int8 trunk weights (post-training "
                         "quantization of the f32 weights, the int8 matmul kernel)")
    ap.add_argument("--ckpt-dir", default=None, help="restore trained params")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the parameter init and the random MDS init")
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="positional-table size (default: from the sequence)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    ap.add_argument("--sp-shards", type=int, default=0,
                    help="run the trunk sequence-parallel over this many cards (the "
                         "sequence length and the MSA rows must be multiples of it; "
                         "0 = one device)")
    ap.add_argument("--full-atom", action="store_true",
                    help="the full structure pipeline with the refiner (parameters of an "
                         "end-to-end checkpoint with --ckpt-dir); writes N/CA/C/O atoms")
    ap.add_argument("--refiner-depth", type=int, default=2)
    add_telemetry_args(ap)  # --trace-out / --trace-max-spans
    args = ap.parse_args(argv)
    if args.full_atom and args.weight_dtype == "int8":
        raise NotImplementedError(
            "--weight-dtype int8 with --full-atom: the full-atom pipeline has no int8 "
            "arm (nor has the JAX CLI's); not ported (ROADMAP A8-e2e-int8)")

    seq_str = args.seq.strip().upper()
    try:
        tokens = aa_to_tokens(seq_str, strict=True)[None]  # (1, L)
    except ValueError as e:
        ap.error(str(e))
    L = tokens.shape[1]
    if args.full_atom and args.sp_shards and (3 * L) % args.sp_shards:
        ap.error(f"--full-atom --sp-shards {args.sp_shards}: the elongated grid (3L = "
                 f"{3 * L}) must divide by the shard count, as in the JAX CLI; padding "
                 f"would change the structure (the trunk's pair mask, mask_i | mask_j, "
                 f"lets pad keys into every real row)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(device)} (TF32 off)")
    model_apply_fn = None
    if args.sp_shards:
        # the trunk over N distinct cards (or N CPU shards on request); the
        # embeddings, the head and the geometry on the first
        mesh = make_mesh({"seq": args.sp_shards},
                         devices=[device] * args.sp_shards if device.type == "cpu" else None)
        device = mesh.devices[0]
        model_apply_fn = functools.partial(alphafold2_apply_sp, mesh=mesh)
        print(f"sequence-parallel trunk over {mesh}")

    msa = msa_mask = None
    if args.msa_file is not None:
        from alphafold2_tpu_torch.utils.msa import load_msa

        msa, msa_mask = load_msa(args.msa_file, query=seq_str,
                                 max_rows=args.max_msa_rows)
        print(f"MSA: {msa.shape[1]} rows x {msa.shape[2]} cols from {args.msa_file}")
    embedds = load_embedds(ap, args, L)
    templates, templates_mask = load_templates(ap, args.templates_file, L, args.full_atom)

    cfg = Alphafold2Config(
        dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        max_seq_len=args.max_seq_len or max(64, 3 * L if args.full_atom else L),
        max_num_msa=args.max_num_msa or max(20, msa.shape[1] if msa is not None else 0),
        **({"num_embedds": embedds.shape[-1]} if embedds is not None else {}),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        weight_dtype=args.weight_dtype,
    )
    gen = torch.Generator().manual_seed(args.seed)
    tracer = tracer_from_args(args)  # NULL_TRACER unless --trace-out
    try:  # a failed prediction keeps its trace
        if args.full_atom:
            predict_full_atom(args, cfg, tokens, seq_str, msa, msa_mask, embedds, templates,
                              templates_mask, gen, device, model_apply_fn, tracer)
        else:
            predict_ca(args, cfg, tokens, seq_str, msa, msa_mask, embedds, templates,
                       templates_mask, gen, device, model_apply_fn, tracer)
    finally:
        finish_trace(tracer, args)


def predict_ca(args, cfg, tokens, seq_str, msa, msa_mask, embedds, templates, templates_mask,
               gen, device, model_apply_fn, tracer):
    """sequence -> CA trace PDB."""
    L = tokens.shape[1]
    # checkpoints hold f32 masters: restore against the f32 twin of the
    # config, then quantize as the weights are served
    restore_cfg = dataclasses.replace(cfg, weight_dtype="f32")
    params, _, _ = restore_params_for_inference(
        args.ckpt_dir, lambda: alphafold2_init(restore_cfg, gen, device))
    params, residency = resident_params(params, cfg)
    print(f"weights: {residency['weight_dtype']}, {residency['weight_bytes']:,} bytes "
          f"resident ({residency['fp32_weight_bytes']:,} in f32)")
    # the span closes after the outputs reach the host
    with tracer.span("predict.forward", cat="predict", length=L):
        out = predict_structure(
            params, cfg, tokens, msa=msa, msa_mask=msa_mask, embedds=embedds,
            templates=templates, templates_mask=templates_mask,
            mds_iters=args.mds_iters, mds_init=args.mds_init, generator=gen,
            device=None if model_apply_fn else device, model_apply_fn=model_apply_fn,
        )
        trace = out["coords"][0].cpu().numpy()
        conf = out["confidence"][0].cpu().numpy()
    print(f"MDS final stress: {float(out['stress'][0]):.4f}")
    print(f"mean confidence: {100 * conf.mean():.1f}/100")
    with tracer.span("predict.write_pdb", cat="predict", length=L):
        coords_to_pdb(args.out, np.asarray(trace, np.float64), sequence=seq_str,
                      atom_names=("CA",), bfactors=100.0 * conf)
    print(f"wrote {args.out} ({L} residues)")


def predict_full_atom(args, cfg, tokens, seq_str, msa, msa_mask, embedds, templates,
                      templates_mask, gen, device, model_apply_fn, tracer):
    """sequence -> refined 14-atom cloud -> N/CA/C/O PDB (the JAX CLI's
    `_predict_full_atom`): the end-to-end parameters (restored from
    --ckpt-dir, or the port's init from --seed), `training/e2e.py
    predict_structure` under inference mode, then the per-residue mean of
    the three per-atom distogram confidences as B-factors."""
    L = tokens.shape[1]
    ecfg = e2e.E2EConfig(model=cfg,
                         refiner=RefinerConfig(num_tokens=14, dim=64, depth=args.refiner_depth),
                         mds_iters=args.mds_iters, mds_init=args.mds_init)
    params, _, _ = restore_params_for_inference(
        args.ckpt_dir, lambda: e2e.e2e_params_init(ecfg, gen, device))
    if embedds is not None:
        # per-residue embeddings -> one per backbone atom (x3 elongation)
        embedds = np.repeat(embedds, 3, axis=1)
    with tracer.span("predict.forward", cat="predict", length=L, full_atom=True), \
            torch.inference_mode():
        out = e2e.predict_structure(
            params, ecfg, tokens, msa=msa, msa_mask=msa_mask, embedds=embedds,
            templates=templates, templates_mask=templates_mask,
            model_apply_fn=model_apply_fn, mds_generator=gen,
            device=None if model_apply_fn else device)
        conf3 = distogram_confidence(torch.softmax(out["distogram_logits"], dim=-1))
        backbone = out["refined"][0, :, :4].cpu().numpy()  # the N, CA, C, O slots
    conf = conf3[0].cpu().numpy().reshape(L, 3).mean(axis=1)
    print(f"mean confidence: {100 * conf.mean():.1f}/100")
    with tracer.span("predict.write_pdb", cat="predict", length=L, full_atom=True):
        coords_to_pdb(args.out, np.asarray(backbone.reshape(-1, 3), np.float64),
                      sequence=seq_str, atom_names=("N", "CA", "C", "O"),
                      bfactors=100.0 * conf)
    print(f"wrote {args.out} ({L} residues, full pipeline)")


if __name__ == "__main__":
    main()
