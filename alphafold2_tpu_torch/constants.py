"""Library-wide constants, copied from alphafold2_tpu/constants.py so the
port imports nothing of the JAX package (whose package import loads JAX):
the vocabulary and distogram constants, and the atom-level ones the
full-atom geometry reads (the 14-slot atom cloud, the carbonyl build
constants, heavy-atom counts per residue).
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

# number of atom slots per residue in the dense atom representation
# (sidechainnet layout: N, CA, C, O, then up to 10 side-chain heavy atoms)
NUM_COORDS_PER_RES = 14

# padding value used in dense atom clouds
GLOBAL_PAD_CHAR = 0

# carbonyl-group build constants used when placing the backbone oxygen
# (reference utils.py:20-21 fallback values)
BOND_LEN_C_O = 1.229
BOND_ANG_CA_C_O = 2.0944

# --- amino-acid vocabulary -------------------------------------------------
#
# Our own, explicitly defined vocabulary (the reference defers to
# sidechainnet's ProteinVocabulary, reference utils.py:11-16). Index 20 is the
# pad/unknown token. Heavy-atom counts include the 4 backbone atoms
# (N, CA, C, O).

AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"  # alphabetical one-letter codes, ids 0..19
PAD_TOKEN_ID = 20

# total heavy atoms per residue (backbone 4 + side chain)
AA_NUM_HEAVY_ATOMS = {
    "A": 5, "C": 6, "D": 8, "E": 9, "F": 11, "G": 4, "H": 10, "I": 8, "K": 9, "L": 8,
    "M": 8, "N": 8, "P": 7, "Q": 9, "R": 11, "S": 6, "T": 7, "V": 7, "W": 14, "Y": 12,
}

# atom-count lookup table indexed by token id; pad rows get 0 atoms
ATOMS_PER_TOKEN = np.array(
    [AA_NUM_HEAVY_ATOMS[aa] for aa in AA_ORDER] + [0], dtype=np.int32
)


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

