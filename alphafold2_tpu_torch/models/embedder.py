"""Protein language-model embedder, the ESM-1b architecture (counterpart of
alphafold2_tpu/models/embedder.py).

A pre-LN transformer encoder with learned fairseq positions, exact-GELU
MLPs and a final LayerNorm, as init/apply over a parameter dict with the
JAX package's names and layouts (a dense weight is (d_in, d_out)). The
defaults are ESM-1b's shape (esm1b_t33_650M_UR50S: 33 layers, width 1280,
20 heads); `convert_esm_state_dict` (fair-esm keys) and
`convert_hf_esm_state_dict` (HuggingFace `EsmModel` keys) map a torch
state dict onto the tree. `esm_tokenize` frames our vocabulary in the ESM
alphabet (<cls> ... <eos>) and `embed_sequences` strips the framing, so
its output aligns 1:1 with residues: the `embedds` input of
`alphafold2_apply` (num_embedds 1280).

The self-attention is the trunk's core, `ops/attention.py attend`, with
the padding as a key-side mask (no pad key is weighed; a row is never all
pad, since <cls> is always valid): on the card the flash forward kernel
B1f (the wgmma route in bf16 at head width 64), or the dense einsum at a
head width the kernels do not take (16, 32, 64); on the CPU the JAX
package's rule (dense below 2^27 logits). LayerNorm eps is ESM-1b's 1e-12
throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from alphafold2_tpu_torch.constants import AA_ORDER
from alphafold2_tpu_torch.device import check_params_device, resolve_device
from alphafold2_tpu_torch.ops.attention import AttentionConfig, attend
from alphafold2_tpu_torch.ops.core import (
    embedding,
    embedding_init,
    layer_norm_init,
    linear,
    linear_init,
)
from alphafold2_tpu_torch.ops.core import layer_norm as _layer_norm

# ESM-1b's LayerNorm eps (fair-esm ESM1bLayerNorm, HF EsmConfig.layer_norm_eps),
# not the model-wide 1e-5: with real weights the wrong eps shifts the
# representations by ~1e-3
_ESM_LN_EPS = 1e-12


def layer_norm(params, x):
    return _layer_norm(params, x, eps=_ESM_LN_EPS)


# the ESM alphabet (fair-esm constants): specials + amino acids in ESM order
ESM_TOKENS = (
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
    "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O",
    ".", "-", "<null_1>", "<mask>",
)
ESM_IDX = {t: i for i, t in enumerate(ESM_TOKENS)}
_CLS, _PAD, _EOS = ESM_IDX["<cls>"], ESM_IDX["<pad>"], ESM_IDX["<eos>"]
_MASK = ESM_IDX["<mask>"]

# our token id (0..19 = AA_ORDER, 20 = pad) -> ESM alphabet id
_OURS_TO_ESM = np.array([ESM_IDX[aa] for aa in AA_ORDER] + [_PAD], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    """ESM-1b shape defaults (esm1b_t33_650M_UR50S). max_len: the longest
    framed length (residues + <cls>/<eos>); fairseq positions reach
    max_len + padding_idx, so the table holds `pos_table_rows` = max_len +
    2 rows, (1026, 1280) for ESM-1b. token_dropout: ESM's inference-time
    <mask> handling (`apply_token_dropout`), on as in ESM-1b."""

    num_layers: int = 33
    dim: int = 1280
    heads: int = 20
    vocab: int = len(ESM_TOKENS)
    max_len: int = 1024
    token_dropout: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def pos_table_rows(self) -> int:
        return self.max_len + _PAD + 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def embedder_init(cfg: EmbedderConfig, generator: torch.Generator, device):
    """Random parameters in the JAX package's tree (its init's
    distributions), drawn from the CPU `generator` and moved to `device`
    (default CUDA; device="cpu" for the CPU)."""
    device = resolve_device(device)
    params = {
        "token_emb": embedding_init(generator, cfg.vocab, cfg.dim, device),
        "pos_emb": embedding_init(generator, cfg.pos_table_rows, cfg.dim, device),
        "pre_norm": layer_norm_init(cfg.dim, device),  # ESM-1b emb_layer_norm_before
        "final_norm": layer_norm_init(cfg.dim, device),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": layer_norm_init(cfg.dim, device),
            "qkv": linear_init(generator, cfg.dim, 3 * cfg.dim, device),
            "attn_out": linear_init(generator, cfg.dim, cfg.dim, device),
            "ff_norm": layer_norm_init(cfg.dim, device),
            "ff_in": linear_init(generator, cfg.dim, 4 * cfg.dim, device),
            "ff_out": linear_init(generator, 4 * cfg.dim, cfg.dim, device),
        })
    return params


def apply_token_dropout(h, tokens, mask):
    """ESM's <mask> handling on token embeddings h (b, n, d), before the
    positions are added: zero the <mask> rows, then rescale every row by
    (1 - 0.15 * 0.8) / (1 - the row's observed <mask> fraction), a flat
    0.88x without <mask> tokens. The fraction's denominator is the row's
    NON-PAD count (fair-esm, the ESM-1b the reference runs)."""
    is_masked = tokens == _MASK
    h = torch.where(is_masked[..., None], 0.0, h)
    mask_ratio_train = 0.15 * 0.8
    src_lengths = mask.float().sum(dim=1).clamp_min(1.0)  # an all-pad row
    ratio_obs = is_masked.float().sum(dim=1) / src_lengths
    return (h * ((1.0 - mask_ratio_train) / (1.0 - ratio_obs))[:, None, None]).to(h.dtype)


def embedder_apply(params, cfg: EmbedderConfig, tokens, mask=None):
    """Forward over ESM-alphabet tokens (b, n) int, with mask (b, n) bool
    (default: the non-pad tokens). Inputs may be numpy arrays or tensors;
    they move to the params' device. Returns the (b, n, dim) final-layer
    representations after the final LayerNorm (the reference's
    `repr_layers=[33]`), in cfg.dtype."""
    dev = params["token_emb"]["table"].device
    check_params_device(params, dev)
    tokens = torch.as_tensor(tokens).long().to(dev)
    b, n = tokens.shape
    if n + _PAD >= cfg.pos_table_rows:
        raise ValueError(
            f"framed length {n} exceeds the positional table "
            f"(max_len={cfg.max_len}); the lookup would run off its end"
        )
    dtype = cfg.dtype
    mask = tokens != _PAD if mask is None else torch.as_tensor(mask).bool().to(dev)

    h = embedding(params["token_emb"], tokens, dtype=dtype)
    if cfg.token_dropout:
        h = apply_token_dropout(h, tokens, mask)
    # fairseq LearnedPositionalEmbedding: the cumulative count of non-pad
    # tokens + padding_idx, pads pinned at padding_idx
    positions = torch.cumsum(mask.long(), dim=1) * mask + _PAD
    h = h + embedding(params["pos_emb"], positions, dtype=dtype)
    h = layer_norm(params["pre_norm"], h)

    hd = cfg.head_dim
    acfg = AttentionConfig(dim=cfg.dim, heads=cfg.heads, dim_head=hd, dtype=dtype)
    for layer in params["layers"]:
        x = layer_norm(layer["attn_norm"], h)
        q, k, v = (t.reshape(b, n, cfg.heads, hd)
                   for t in linear(layer["qkv"], x, dtype=dtype).chunk(3, dim=-1))
        o = attend(acfg, q, k, v, context_mask=mask)
        h = h + linear(layer["attn_out"], o, dtype=dtype)
        x = layer_norm(layer["ff_norm"], h)
        x = F.gelu(linear(layer["ff_in"], x, dtype=dtype))  # exact (erf) GELU
        h = h + linear(layer["ff_out"], x, dtype=dtype)
    return layer_norm(params["final_norm"], h)


def esm_tokenize(our_tokens, our_mask=None):
    """Our AA tokens (b, L) -> ESM-alphabet tokens (b, L + 2) framed
    <cls> ... <eos>, and the framed mask, as tensors on the tokens' device.
    As ESM's BatchConverter, <eos> sits right after each row's LAST valid
    residue (from the last true index, so a non-contiguous mask never puts
    it over a valid residue); an all-masked row gets it right after <cls>."""
    our_tokens = torch.as_tensor(our_tokens).long()
    dev = our_tokens.device
    b, L = our_tokens.shape
    core = torch.as_tensor(_OURS_TO_ESM, device=dev).long()[our_tokens]
    our_mask = (torch.ones((b, L), dtype=torch.bool, device=dev) if our_mask is None
                else torch.as_tensor(our_mask).bool().to(dev))
    core = torch.where(our_mask, core, _PAD)
    tokens = torch.cat([torch.full((b, 1), _CLS, device=dev), core,
                        torch.full((b, 1), _PAD, device=dev)], dim=1)
    mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), our_mask,
                      torch.zeros((b, 1), dtype=torch.bool, device=dev)], dim=1)
    pos = torch.arange(L, device=dev)[None, :]
    last_valid = torch.where(our_mask, pos, -1).amax(dim=1)
    idx = torch.arange(L + 2, device=dev)[None, :]
    at_eos = idx == (last_valid + 2)[:, None]
    return torch.where(at_eos, _EOS, tokens), mask | at_eos


def embed_sequences(params, cfg: EmbedderConfig, our_tokens, our_mask=None):
    """Our-vocabulary sequences (b, L) -> (b, L, dim) residue embeddings,
    aligned 1:1 with the residues (the framing stripped, the reference's
    `[..., 1:-1]`), on the params' device."""
    dev = params["token_emb"]["table"].device
    tokens, mask = esm_tokenize(torch.as_tensor(our_tokens).to(dev),
                                None if our_mask is None else torch.as_tensor(our_mask).to(dev))
    return embedder_apply(params, cfg, tokens, mask)[:, 1:-1]


# --- torch weight conversion ------------------------------------------------

def _host(v) -> np.ndarray:
    """A state-dict value (numpy array or torch tensor) as a float32 array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_esm_state_dict(state_dict, cfg: EmbedderConfig, device=None):
    """Map a fair-esm ESM-1b `state_dict()` (numpy arrays or tensors) onto
    the embedder tree on `device` (default CUDA). Keys: `embed_tokens`,
    `embed_positions`, `emb_layer_norm_before` / `_after`, and a layer's
    `self_attn.{q,k,v,out}_proj`, `self_attn_layer_norm`, `fc1`, `fc2`,
    `final_layer_norm`. Torch Linear stores (out, in); ours is (in, out)."""
    device = resolve_device(device)
    sd = {k: _host(v) for k, v in state_dict.items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def lin(prefix):
        return {"w": sd[f"{prefix}.weight"].T, "b": sd[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": t(sd[f"{prefix}.weight"]), "bias": t(sd[f"{prefix}.bias"])}

    def dense(d):
        return {k: t(v) for k, v in d.items()}

    params = {
        "token_emb": {"table": t(sd["embed_tokens.weight"])},
        "pos_emb": {"table": t(sd["embed_positions.weight"])},
        "pre_norm": norm("emb_layer_norm_before"),
        "final_norm": norm("emb_layer_norm_after"),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        q, k, v = (lin(f"{p}.self_attn.{x}_proj") for x in "qkv")
        params["layers"].append({
            "attn_norm": norm(f"{p}.self_attn_layer_norm"),
            "qkv": dense({"w": np.concatenate([q["w"], k["w"], v["w"]], axis=1),
                          "b": np.concatenate([q["b"], k["b"], v["b"]])}),
            "attn_out": dense(lin(f"{p}.self_attn.out_proj")),
            "ff_norm": norm(f"{p}.final_layer_norm"),
            "ff_in": dense(lin(f"{p}.fc1")),
            "ff_out": dense(lin(f"{p}.fc2")),
        })
    return params


# HuggingFace transformers EsmModel key -> fair-esm ProteinBertModel key
_HF_STATIC = {
    "embeddings.word_embeddings.weight": "embed_tokens.weight",
    "embeddings.position_embeddings.weight": "embed_positions.weight",
    "embeddings.layer_norm.weight": "emb_layer_norm_before.weight",
    "embeddings.layer_norm.bias": "emb_layer_norm_before.bias",
    "encoder.emb_layer_norm_after.weight": "emb_layer_norm_after.weight",
    "encoder.emb_layer_norm_after.bias": "emb_layer_norm_after.bias",
}
_HF_LAYER = {
    "attention.self.query": "self_attn.q_proj",
    "attention.self.key": "self_attn.k_proj",
    "attention.self.value": "self_attn.v_proj",
    "attention.output.dense": "self_attn.out_proj",
    "attention.LayerNorm": "self_attn_layer_norm",
    "intermediate.dense": "fc1",
    "output.dense": "fc2",
    "LayerNorm": "final_layer_norm",
}


def convert_hf_esm_state_dict(state_dict, cfg: EmbedderConfig, device=None):
    """Map a HuggingFace `EsmModel` state dict of the absolute-position
    ESM-1b family onto the embedder tree, through the fair-esm layout.
    Refuses an ESM-2 / rotary layout (no position table, no
    emb_layer_norm_before) and a checkpoint deeper than cfg.num_layers
    (it would be truncated silently), each with a ValueError."""
    sd = {}
    for key, val in state_dict.items():
        key = key.removeprefix("esm.")
        if key in _HF_STATIC:
            sd[_HF_STATIC[key]] = val
            continue
        if key.startswith("encoder.layer."):
            _, _, idx, rest = key.split(".", 3)
            stem, leaf = rest.rsplit(".", 1)
            if stem in _HF_LAYER:
                sd[f"layers.{idx}.{_HF_LAYER[stem]}.{leaf}"] = val
        # the pooler, contact head and rotary buffers are not on the
        # representation path
    missing = [k for k in
               ("embed_tokens.weight", "embed_positions.weight",
                "emb_layer_norm_before.weight", "emb_layer_norm_after.weight")
               if k not in sd]
    missing += [f"layers.{i}.self_attn.q_proj.weight" for i in range(cfg.num_layers)
                if f"layers.{i}.self_attn.q_proj.weight" not in sd]
    if missing:
        raise ValueError(
            "state dict does not look like an absolute-position ESM-1b "
            f"family EsmModel (missing after mapping: {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}). ESM-2/rotary "
            "checkpoints (no position table, no emb_layer_norm_before) "
            "are not supported by this converter; check cfg.num_layers "
            "matches the checkpoint depth."
        )
    extra = f"layers.{cfg.num_layers}.self_attn.q_proj.weight"
    if extra in sd:
        raise ValueError(
            f"checkpoint has more encoder layers than cfg.num_layers="
            f"{cfg.num_layers} (found {extra}); refusing to silently "
            "truncate — set cfg.num_layers to the checkpoint depth"
        )
    return convert_esm_state_dict(sd, cfg, device)
