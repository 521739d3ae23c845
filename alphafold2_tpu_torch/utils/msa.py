"""Host-side MSA file parsing: FASTA / A3M -> token arrays (a copy of
alphafold2_tpu/utils/msa.py, kept here so the port imports nothing of the
JAX package).

The model is MSA-centric (reference README.md:17-48 feeds `msa` alongside
the sequence; reference `constants.py:5` caps rows at MAX_NUM_MSA=20), but
the reference ships no way to get an alignment INTO the model. This module
closes that gap for the predict CLI: parse a FASTA or A3M alignment file
into the (rows, cols) token/mask arrays `alphafold2_apply` consumes.

A3M conventions honored: lowercase letters are insertions relative to the
query and are removed (standard a3m semantics, so every kept row aligns
column-wise with the first/query row); '-' and '.' are gaps. Gaps map to
the pad token and are masked out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from alphafold2_tpu_torch.constants import MAX_NUM_MSA, aa_to_tokens


def parse_alignment(path: str) -> list[tuple[str, str]]:
    """Read FASTA/A3M records as (header, sequence) pairs.

    Lowercase (a3m insertion) columns are stripped; '.' gaps normalize to
    '-'. Raises on an empty file or on aligned rows of unequal length.
    """
    records: list[tuple[str, str]] = []
    header, parts = None, []

    def flush():
        if header is not None:
            seq = "".join(parts)
            seq = "".join(c for c in seq if not c.islower()).replace(".", "-")
            records.append((header, seq))

    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith((";", "#")):
                continue
            if line.startswith(">"):
                flush()
                header, parts = line[1:].strip(), []
            else:
                if header is None:
                    header = ""  # headerless plain-text alignment
                parts.append(line)
    flush()

    if not records:
        raise ValueError(f"no sequences found in alignment file {path!r}")
    width = len(records[0][1])
    for name, seq in records:
        if len(seq) != width:
            raise ValueError(
                f"alignment rows differ in length after removing "
                f"insertions: {name!r} has {len(seq)}, query has {width} "
                f"(is this really a FASTA/A3M alignment?)"
            )
    return records


def load_msa(
    path: str,
    query: Optional[str] = None,
    max_rows: int = MAX_NUM_MSA,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alignment file -> (msa_tokens (1, R, C) int32, msa_mask (1, R, C) bool).

    The first record is conventionally the query; when `query` is given it
    is checked against that row (gaps removed) so a mismatched alignment
    fails loudly instead of silently conditioning on the wrong protein.
    Rows beyond `max_rows` are dropped from the end (reference
    MAX_NUM_MSA=20 cap, constants.py:5).
    """
    records = parse_alignment(path)
    q_row = records[0][1].upper()
    if "-" in q_row:
        # Clustal/MUSCLE-style alignments may gap the query row; MSA columns
        # must line up with query residue positions (the model adds column
        # position embeddings by raw index), so drop query-gap columns —
        # this maps every row into query coordinates
        keep = [i for i, c in enumerate(q_row) if c != "-"]
        records = [(h, "".join(s[i] for i in keep)) for h, s in records]
    if query is not None:
        q = records[0][1].upper()
        if q != query.upper():
            raise ValueError(
                f"alignment query row ({len(q)} residues) does not match "
                f"--seq ({len(query)} residues): the MSA belongs to a "
                f"different protein or alignment"
            )
    rows = [seq.upper() for _, seq in records[:max_rows]]
    tokens = np.stack([aa_to_tokens(seq) for seq in rows])  # gaps -> pad id
    mask = np.stack(
        [np.array([c != "-" for c in seq], dtype=bool) for seq in rows]
    )
    return tokens[None].astype(np.int32), mask[None]
