"""Inference entry point: amino-acid sequence -> CA trace -> PDB, on the
port (counterpart of predict.py's CA-trace path).

Usage:
  python -m alphafold2_tpu_torch.predict --seq ACDEFGHIKLMNPQRSTVWY --out s.pdb
  python -m alphafold2_tpu_torch.predict --seq ... --msa-file aln.a3m --bf16
  python -m alphafold2_tpu_torch.predict --seq ... --device cpu
  python -m alphafold2_tpu_torch.predict --seq ... --bf16 --weight-dtype int8
  python -m alphafold2_tpu_torch.predict --seq ... --sp-shards 4

Parameters come from `--seed` through the port's own init; restoring a
JAX checkpoint waits for the checkpoint port. `--weight-dtype int8` serves
them through `serving/quant_residency.py resident_params`, as the JAX
serving engine does. Runs on the GPU unless
`--device cpu` is given; float32 matmuls and convolutions run in full
float32 there (TF32 off). `--sp-shards N` runs the trunk sequence-parallel
(parallel/sp_trunk.py alphafold2_apply_sp) over N distinct cards, so it
needs N of them, as the JAX CLI needs N devices; with `--device cpu` the N
shards run on the CPU.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from alphafold2_tpu_torch.constants import aa_to_tokens
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.geometry.pdb import coords_to_pdb
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.parallel import alphafold2_apply_sp, make_mesh
from alphafold2_tpu_torch.serving.pipeline import predict_structure
from alphafold2_tpu_torch.serving.quant_residency import resident_params


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
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--weight-dtype", choices=("f32", "int8"), default="f32",
                    help="int8: serve per-channel int8 trunk weights (post-training "
                         "quantization of the f32 weights, the int8 matmul kernel)")
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
    args = ap.parse_args(argv)

    seq_str = args.seq.strip().upper()
    try:
        tokens = aa_to_tokens(seq_str, strict=True)[None]  # (1, L)
    except ValueError as e:
        ap.error(str(e))
    L = tokens.shape[1]
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

    cfg = Alphafold2Config(
        dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        max_seq_len=args.max_seq_len or max(64, L),
        max_num_msa=args.max_num_msa or max(20, msa.shape[1] if msa is not None else 0),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        weight_dtype=args.weight_dtype,
    )
    gen = torch.Generator().manual_seed(args.seed)
    params, residency = resident_params(alphafold2_init(cfg, gen, device), cfg)
    print(f"weights: {residency['weight_dtype']}, {residency['weight_bytes']:,} bytes "
          f"resident ({residency['fp32_weight_bytes']:,} in f32)")
    out = predict_structure(
        params, cfg, tokens, msa=msa, msa_mask=msa_mask,
        mds_iters=args.mds_iters, mds_init=args.mds_init, generator=gen,
        device=None if model_apply_fn else device, model_apply_fn=model_apply_fn,
    )
    trace = out["coords"][0].cpu().numpy()
    conf = out["confidence"][0].cpu().numpy()
    print(f"MDS final stress: {float(out['stress'][0]):.4f}")
    print(f"mean confidence: {100 * conf.mean():.1f}/100")
    coords_to_pdb(args.out, np.asarray(trace, np.float64), sequence=seq_str,
                  atom_names=("CA",), bfactors=100.0 * conf)
    print(f"wrote {args.out} ({L} residues)")


if __name__ == "__main__":
    main()
