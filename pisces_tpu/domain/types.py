"""Core enums and constants for the JAX Pisces rebuild.

Semantics mirror the reference implementation's domain model
(src/lib/Pisces.Domain/Types/*.cs, src/lib/Pisces.Domain/Constants.cs) but are
re-expressed as integer codes suitable for dense tensor layouts.
"""
from __future__ import annotations

import enum

import numpy as np


class AlleleType(enum.IntEnum):
    """Base identity codes (reference: Types/AlleleType.cs)."""

    A = 0
    G = 1
    C = 2
    T = 3
    N = 4
    DELETION = 5


class DirectionType(enum.IntEnum):
    """Read direction of a base observation (reference: Types/DirectionType.cs)."""

    FORWARD = 0
    REVERSE = 1
    STITCHED = 2


class AlleleCategory(enum.IntEnum):
    """Variant category (reference: Types/AlleleCategory in Pisces.Domain)."""

    REFERENCE = 0
    SNV = 1
    MNV = 2
    INSERTION = 3
    DELETION = 4
    NON_REFERENCE = 5
    UNSUPPORTED = 6


class Genotype(enum.IntEnum):
    """Genotype codes (reference: Types/Genotype.cs)."""

    HETEROZYGOUS_ALT1_ALT2 = 0  # 1/2
    ALT12_LIKE_NOCALL = 1       # ./.
    HETEROZYGOUS_ALT_REF = 2    # 0/1
    HOMOZYGOUS_ALT = 3          # 1/1
    HOMOZYGOUS_REF = 4          # 0/0
    REF_LIKE_NOCALL = 5         # ./.
    ALT_LIKE_NOCALL = 6         # ./.
    REF_AND_NOCALL = 7          # 0/.
    ALT_AND_NOCALL = 8          # 1/.
    HEMIZYGOUS_REF = 9          # 0
    HEMIZYGOUS_ALT = 10         # 1
    HEMIZYGOUS_NOCALL = 11      # .
    OTHERS = 12                 # */*


GENOTYPE_STRINGS = {
    Genotype.HOMOZYGOUS_ALT: "1/1",
    Genotype.HOMOZYGOUS_REF: "0/0",
    Genotype.HETEROZYGOUS_ALT_REF: "0/1",
    Genotype.HETEROZYGOUS_ALT1_ALT2: "1/2",
    Genotype.REF_LIKE_NOCALL: "./.",
    Genotype.ALT_LIKE_NOCALL: "./.",
    Genotype.ALT12_LIKE_NOCALL: "./.",
    Genotype.REF_AND_NOCALL: "0/.",
    Genotype.ALT_AND_NOCALL: "1/.",
    Genotype.HEMIZYGOUS_ALT: "1",
    Genotype.HEMIZYGOUS_NOCALL: ".",
    Genotype.HEMIZYGOUS_REF: "0",
    Genotype.OTHERS: "2/2",
}

NOCALL_GENOTYPES = frozenset(
    {
        Genotype.ALT12_LIKE_NOCALL,
        Genotype.ALT_LIKE_NOCALL,
        Genotype.HEMIZYGOUS_NOCALL,
        Genotype.REF_LIKE_NOCALL,
    }
)


class FilterType(enum.IntEnum):
    """VCF filter codes (reference: Types/FilterType.cs)."""

    STRAND_BIAS = 0
    POOL_BIAS = 1
    AMPLICON_BIAS = 2
    LOW_VARIANT_QSCORE = 3
    LOW_DEPTH = 4
    LOW_VARIANT_FREQUENCY = 5
    LOW_GENOTYPE_QUALITY = 6
    INDEL_REPEAT_LENGTH = 7
    MULTI_ALLELIC_SITE = 8
    RMXN = 9
    FORCED_REPORT = 10
    OFF_TARGET = 11
    NO_CALL = 12
    UNKNOWN = 13


class PloidyModel(enum.IntEnum):
    SOMATIC = 0
    DIPLOID_BY_THRESHOLDING = 1
    DIPLOID_BY_ADAPTIVE_GT = 2
    HAPLOID = 3


class NoiseModel(enum.IntEnum):
    FLAT = 0
    WINDOW = 1


class StrandBiasModel(enum.IntEnum):
    POISSON = 0
    EXTENDED = 1
    DIPLOID = 2


class CoverageMethod(enum.IntEnum):
    APPROXIMATE = 0
    EXACT = 1


class ReadCollapsedType(enum.IntEnum):
    DUPLEX_STITCHED = 0
    DUPLEX_NON_STITCHED = 1
    SIMPLEX_STITCHED = 2
    SIMPLEX_FORWARD_STITCHED = 3
    SIMPLEX_REVERSE_STITCHED = 4
    SIMPLEX_NON_STITCHED = 5
    SIMPLEX_FORWARD_NON_STITCHED = 6
    SIMPLEX_REVERSE_NON_STITCHED = 7


# Reference: Constants.cs
NUM_ALLELE_TYPES = 6
NUM_DIRECTION_TYPES = 3
NUM_READ_COLLAPSED_TYPES = 8
MAX_NUM_OVERLAPPING_AMPLICONS = 6
COVERAGE_CONTRIBUTING_ALLELES = (
    AlleleType.A,
    AlleleType.C,
    AlleleType.G,
    AlleleType.T,
    AlleleType.DELETION,
)

# Default anchor tracking (reference: PiscesApplicationOptions.TrackedAnchorSize)
DEFAULT_ANCHOR_SIZE = 5


def num_anchor_indexes(anchor_size: int) -> int:
    """Anchor axis length: [0..A-1] left anchors, [A] well-anchored, [A+1..2A] right."""
    return 2 * anchor_size + 1


# Base-char <-> AlleleType code mapping, vectorized-friendly.
# ASCII lookup table: maps byte value of base char to AlleleType code; default N.
BASE_TO_ALLELE = np.full(256, int(AlleleType.N), dtype=np.int8)
for _ch, _code in (("A", AlleleType.A), ("G", AlleleType.G), ("C", AlleleType.C),
                   ("T", AlleleType.T), ("a", AlleleType.A), ("g", AlleleType.G),
                   ("c", AlleleType.C), ("t", AlleleType.T)):
    BASE_TO_ALLELE[ord(_ch)] = int(_code)

ALLELE_TO_BASE = np.frombuffer(b"AGCTN-", dtype=np.uint8)


def get_allele_type(base: str) -> AlleleType:
    """Scalar helper mirroring AlleleHelper.GetAlleleType."""
    return AlleleType(int(BASE_TO_ALLELE[ord(base)]))
