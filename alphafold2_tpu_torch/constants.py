"""Library-wide constants: the part of alphafold2_tpu/constants.py that
the ported slice uses, copied so the port imports nothing of the JAX
package (whose package import loads JAX). The atom-level constants come
with the geometry port (ROADMAP A8).
"""

import numpy as np

# maximum number of rows of a multiple sequence alignment the row-position
# embedding table supports
MAX_NUM_MSA = 20

# 20 standard amino acids + 1 pad/unknown token
NUM_AMINO_ACIDS = 21

# width of precomputed language-model residue embeddings (ESM-1b final layer)
NUM_EMBEDDS_TR = 1280

# number of distance buckets of the distogram head (AlphaFold1-style)
DISTOGRAM_BUCKETS = 37

# distogram bucket boundaries in Angstroms (reference utils.py:29)
DISTANCE_THRESHOLDS = np.linspace(2.0, 20.0, DISTOGRAM_BUCKETS)

# --- amino-acid vocabulary -------------------------------------------------
#
# Our own, explicitly defined vocabulary (the reference defers to
# sidechainnet's ProteinVocabulary, reference utils.py:11-16). Index 20 is the
# pad/unknown token.

AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"  # alphabetical one-letter codes, ids 0..19
PAD_TOKEN_ID = 20


def aa_to_tokens(seq: str, strict: bool = False) -> np.ndarray:
    """Encode a one-letter amino-acid string into integer tokens.

    By default unknown characters map to PAD_TOKEN_ID — the lenient
    behavior alignment parsing relies on (gaps and a3m '-' become pad).
    With ``strict=True`` any character outside the 20-residue vocabulary
    raises ValueError instead: request-facing boundaries (predict.py,
    serving.engine) must fail garbage input fast rather than silently
    predicting a structure for padding.
    """
    lookup = {aa: i for i, aa in enumerate(AA_ORDER)}
    if strict:
        bad = sorted({c for c in seq if c.upper() not in lookup})
        if bad:
            raise ValueError(
                f"invalid residue code(s) {''.join(bad)!r} in sequence "
                f"(valid one-letter codes: {AA_ORDER})"
            )
        if not seq:
            raise ValueError("empty sequence")
    return np.array([lookup.get(c.upper(), PAD_TOKEN_ID) for c in seq], dtype=np.int32)

