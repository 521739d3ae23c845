"""The ESM-1b embedder (`alphafold2_tpu_torch/models/embedder.py`), port vs
JAX package, float32 on the CPU, on the same parameters (embedder_init ->
embedder_params_from_jax) and inputs made from a numpy seed.

Tolerances: the tokenizer's framing equal; representations at 5e-6
relative to max(1, |ref|) (both attentions are dense einsums at these
sizes, the port's through the trunk's `attend`: the same f32 function,
the rest of the layer in another summation order); the converters' output equal to the JAX
converters' leaf for leaf; HuggingFace's `EsmModel` (a third, independent
torch implementation, where `transformers` imports) at 2e-5, the JAX
package's own bound for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models import embedder as jemb
from alphafold2_tpu_torch.models import embedder as temb
from alphafold2_tpu_torch.models.convert import embedder_params_from_jax

TINY = dict(num_layers=2, dim=64, heads=4, max_len=30)


def make(token_dropout=True, **kw):
    cfg_kw = {**TINY, **kw}
    jcfg = jemb.EmbedderConfig(token_dropout=token_dropout, **cfg_kw)
    tcfg = temb.EmbedderConfig(token_dropout=token_dropout, **cfg_kw)
    jparams = jemb.embedder_init(jax.random.PRNGKey(0), jcfg)
    tparams = embedder_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, jcfg, tparams, tcfg


def assert_close(got, want, rel=5e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, np.abs(want).max()))


def test_tokenizer_framing_matches_with_non_contiguous_masks():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 21, (4, 9)).astype(np.int32)
    mask = rng.random((4, 9)) > 0.3
    mask[2] = False  # all masked: <eos> right after <cls>
    mask[3] = True
    for m in (None, mask):
        jt, jm = jemb.esm_tokenize(seq, m)
        tt, tm = temb.esm_tokenize(seq, m)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert temb.ESM_TOKENS == jemb.ESM_TOKENS
    np.testing.assert_array_equal(temb._OURS_TO_ESM, jemb._OURS_TO_ESM)
    assert temb.EmbedderConfig().pos_table_rows == jemb.EmbedderConfig().pos_table_rows == 1026


@pytest.mark.parametrize("token_dropout", [False, True], ids=["no-dropout", "dropout"])
@pytest.mark.parametrize("mask_tokens", [False, True], ids=["plain", "mask-tokens"])
def test_embedder_apply_matches_jax(token_dropout, mask_tokens):
    """embedder_apply on a padded batch, with <mask> tokens or without,
    and embed_sequences (framing stripped) on a non-contiguous mask."""
    jp, jc, tp, tc = make(token_dropout)
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 20, (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), bool)
    mask[1, 7:] = False
    tokens, fmask = (np.asarray(a) for a in jemb.esm_tokenize(seq, mask))
    if mask_tokens:
        tokens = tokens.copy()
        tokens[0, [3, 5]] = jemb.ESM_IDX["<mask>"]
        tokens[1, 2] = jemb.ESM_IDX["<mask>"]
    want = jemb.embedder_apply(jp, jc, jnp.asarray(tokens), jnp.asarray(fmask))
    got = temb.embedder_apply(tp, tc, tokens, fmask)
    assert got.shape == (2, 13, 64)
    assert_close(got, want)
    mask[0, 4] = False
    assert_close(temb.embed_sequences(tp, tc, seq, mask), jemb.embed_sequences(jp, jc, seq, mask))
    assert_close(temb.embed_sequences(tp, tc, seq), jemb.embed_sequences(jp, jc, seq))


def test_padded_row_equals_the_row_alone():
    """A row's representations do not depend on padding after it, also
    with a <mask> token (the observed mask fraction counts non-pad tokens
    only): as in the JAX package."""
    _, _, tp, tc = make()
    seq = np.array([[0, 1, 2, 3, 4]])
    tokens, mask = temb.esm_tokenize(seq)
    tokens[0, 2] = temb.ESM_IDX["<mask>"]
    alone = temb.embedder_apply(tp, tc, tokens, mask)
    pad = torch.full((1, 3), temb.ESM_IDX["<pad>"])
    padded = temb.embedder_apply(tp, tc, torch.cat([tokens, pad], 1),
                                 torch.cat([mask, torch.zeros((1, 3), dtype=torch.bool)], 1))
    torch.testing.assert_close(padded[:, :7], alone, rtol=0, atol=1e-5)


def test_token_dropout_rescale_matches_jax():
    rng = np.random.RandomState(0)
    h = rng.randn(2, 6, 8).astype(np.float32)
    idx = jemb.ESM_IDX
    tokens = np.array([[5, 6, 7, 8, 9, idx["<pad>"]], [5, idx["<mask>"], 7, 8, 9, idx["<pad>"]]])
    mask = np.array([[True] * 5 + [False]] * 2)
    got = temb.apply_token_dropout(torch.from_numpy(h), torch.from_numpy(tokens),
                                   torch.from_numpy(mask))
    want = jemb.apply_token_dropout(jnp.asarray(h), jnp.asarray(tokens), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), 0.88 * h[0], rtol=1e-6)


def test_overlong_sequence_is_refused():
    _, _, tp, tc = make()
    with pytest.raises(ValueError, match="exceeds the positional table"):
        temb.embed_sequences(tp, tc, np.zeros((1, tc.max_len), np.int32))
    # the longest framed length the table holds runs
    out = temb.embed_sequences(tp, tc, np.zeros((1, tc.max_len - 2), np.int32))
    assert torch.isfinite(out).all()


def test_bf16_embedder_tracks_f32():
    """bf16 compute (P cast to bf16 before P.V, as JAX does) stays within
    the bf16 bound of the f32 result: each residue's cosine >= 0.99."""
    _, _, tp, tc = make()
    seq = np.random.default_rng(2).integers(0, 20, (1, 12))
    f32 = temb.embed_sequences(tp, tc, seq)
    b16 = temb.embed_sequences(tp, temb.EmbedderConfig(**TINY, dtype=torch.bfloat16), seq)
    assert b16.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(b16.float(), f32, dim=-1)
    assert float(cos.min()) >= 0.99


def _fair_esm_state_dict(cfg, seed=0):
    """A fair-esm ESM-1b layout state dict of random weights at cfg's shape."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    sd = {"embed_tokens.weight": r(cfg.vocab, cfg.dim),
          "embed_positions.weight": r(cfg.pos_table_rows, cfg.dim)}
    for name in ("emb_layer_norm_before", "emb_layer_norm_after"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1.0 + r(cfg.dim), r(cfg.dim)
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"] = r(cfg.dim, cfg.dim)
            sd[f"{p}.self_attn.{proj}.bias"] = r(cfg.dim)
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}.{norm}.weight"], sd[f"{p}.{norm}.bias"] = 1.0 + r(cfg.dim), r(cfg.dim)
        sd[f"{p}.fc1.weight"], sd[f"{p}.fc1.bias"] = r(4 * cfg.dim, cfg.dim), r(4 * cfg.dim)
        sd[f"{p}.fc2.weight"], sd[f"{p}.fc2.bias"] = r(cfg.dim, 4 * cfg.dim), r(cfg.dim)
    return sd


def _to_hf(sd):
    """The same weights in HuggingFace `EsmModel` keys."""
    static = {v: k for k, v in temb._HF_STATIC.items()}
    layer = {v: k for k, v in temb._HF_LAYER.items()}
    out = {}
    for key, val in sd.items():
        if key in static:
            out["esm." + static[key]] = val
        else:
            _, idx, rest = key.split(".", 2)
            stem, leaf = rest.rsplit(".", 1)
            out[f"encoder.layer.{idx}.{layer[stem]}.{leaf}"] = val
    return out


@pytest.mark.parametrize("layout", ["fair-esm", "huggingface"])
def test_converters_match_jax_on_a_built_state_dict(layout):
    """Both converters map a state dict built here (numpy arrays, or torch
    tensors) onto the tree the JAX converters give, leaf for leaf; the
    embeddings of the converted weights agree."""
    jc, tc = jemb.EmbedderConfig(**TINY), temb.EmbedderConfig(**TINY)
    sd = _fair_esm_state_dict(tc)
    if layout == "huggingface":
        sd = _to_hf(sd)
        jp = jemb.convert_hf_esm_state_dict(sd, jc)
        tp = temb.convert_hf_esm_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                            tc, device="cpu")
    else:
        jp = jemb.convert_esm_state_dict(sd, jc)
        tp = temb.convert_esm_state_dict(sd, tc, device="cpu")
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = jax.tree_util.tree_leaves(tp)
    assert len(jleaves) == len(tleaves) == 2 + 2 * 2 + TINY["num_layers"] * 12
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, jp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, tp))
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    seq = np.random.default_rng(3).integers(0, 20, (2, 10))
    assert_close(temb.embed_sequences(tp, tc, seq), jemb.embed_sequences(jp, jc, seq))


def test_hf_converter_refuses_an_esm2_layout_and_a_deeper_checkpoint():
    cfg = temb.EmbedderConfig(num_layers=1, dim=8, heads=2, max_len=16)
    rotary = {"embeddings.word_embeddings.weight": np.zeros((cfg.vocab, 8), np.float32),
              "encoder.layer.0.attention.self.rotary_embeddings.inv_freq":
                  np.zeros(4, np.float32)}
    with pytest.raises(ValueError, match="ESM-2/rotary"):
        temb.convert_hf_esm_state_dict(rotary, cfg, device="cpu")
    deeper = _to_hf(_fair_esm_state_dict(temb.EmbedderConfig(num_layers=2, dim=8, heads=2,
                                                              max_len=16)))
    with pytest.raises(ValueError, match="silently truncate"):
        temb.convert_hf_esm_state_dict(deeper, cfg, device="cpu")


@pytest.mark.parametrize("token_dropout", [False, True], ids=["no-dropout", "dropout"])
def test_embedder_matches_transformers_esm(token_dropout):
    """HuggingFace's EsmModel (absolute positions, ESM-1b's
    emb_layer_norm_before) on random weights, converted by the port's HF
    converter: representations at valid positions agree, unpadded rows
    with <mask> tokens too (HF divides the observed mask fraction by the
    padded length on padded rows, fair-esm by the non-pad count)."""
    tfm = pytest.importorskip("transformers")
    cfg = temb.EmbedderConfig(token_dropout=token_dropout, **TINY)
    torch.manual_seed(0)
    model = tfm.EsmModel(tfm.EsmConfig(
        vocab_size=cfg.vocab, hidden_size=cfg.dim, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.heads, intermediate_size=4 * cfg.dim,
        position_embedding_type="absolute", max_position_embeddings=cfg.pos_table_rows,
        pad_token_id=temb.ESM_IDX["<pad>"], mask_token_id=temb.ESM_IDX["<mask>"],
        emb_layer_norm_before=True, token_dropout=token_dropout, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), add_pooling_layer=False).eval()
    params = temb.convert_hf_esm_state_dict(model.state_dict(), cfg, device="cpu")
    seq = np.random.RandomState(1).randint(0, 20, size=(2, 11))
    for row2_len, inject in ((7, False), (11, True)):
        mask = np.arange(11)[None] < np.array([[11], [row2_len]])
        tokens, fmask = temb.esm_tokenize(seq, mask)
        if inject:
            tokens[0, 3] = tokens[1, 2] = temb.ESM_IDX["<mask>"]
        with torch.no_grad():
            want = model(input_ids=tokens, attention_mask=fmask.long()).last_hidden_state
            got = temb.embedder_apply(params, cfg, tokens, fmask)
        torch.testing.assert_close(got[fmask], want[fmask], rtol=0, atol=2e-5)
