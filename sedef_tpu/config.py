"""Global configuration for the segmental-duplication engine.

Mirrors the tunables of the reference implementation (``src/globals.h:24-110``
and ``src/globals.cc:16-39``) so that outputs are comparable, but exposes them
as mutable dataclasses instead of C++ static members.  Derived parameters are
recomputed through :meth:`Config.finalize` exactly like the reference does
after CLI parsing (``src/search_main.cc:223``, ``src/globals.cc:30``).
"""

from __future__ import annotations

import dataclasses

KB = 1000
MB = 1000 * KB
GB = 1000 * MB


@dataclasses.dataclass
class SearchParams:
    """Stage-1 seeding parameters (reference ``globals.h:25-39``)."""

    kmer_size: int = 12
    window_size: int = 16
    min_uppercase: int = 12  # == kmer_size by default (globals.cc:18)
    max_error: float = 0.30
    max_edit_error: float = 0.15
    gap_frequency: float = 0.005
    min_read_size: int = 700  # KB * (1 - max_error)  (globals.cc:23)
    max_sd_size: int = 1 * 1024 * 1024  # hard 1 MB cap (globals.h:38)

    @property
    def error_ratio(self) -> float:
        # (MAX_ERROR - MAX_EDIT_ERROR) / MAX_EDIT_ERROR  (util.cc:53-55)
        return (self.max_error - self.max_edit_error) / self.max_edit_error

    @property
    def max_gap_error(self) -> float:
        return self.max_error - self.max_edit_error


@dataclasses.dataclass
class HashParams:
    """Minimizer index parameters (reference ``globals.h:41-44``)."""

    index_cutoff: float = 0.001  # drop top 0.001% most frequent hashes


@dataclasses.dataclass
class AlignParams:
    """Full-SD alignment scoring (reference ``globals.h:46-55``)."""

    match: int = 5
    mismatch: int = -4
    gap_open: int = -40
    gap_extend: int = -1
    max_ksw_seq_len: int = 60 * KB  # diagonal chunking bound (globals.h:54)


@dataclasses.dataclass
class ExtendParams:
    """Seed-hit extension before re-alignment (reference ``globals.h:57-66``)."""

    ratio: float = 5.0
    max_extend: int = 15 * KB
    merge_dist: int = 250


@dataclasses.dataclass
class RefineParams:
    """Chain-refinement DP scoring (reference ``globals.h:78-87``)."""

    match: float = 10.0
    mismatch: float = 1.0
    gap: float = 0.5
    gap_open: float = 100.0
    min_read: int = 900
    side_align: int = 500
    max_gap: int = 10 * KB


@dataclasses.dataclass
class ChainParams:
    """Anchor chaining parameters (reference ``globals.h:68-87``)."""

    min_uppercase_match: int = 90
    match_chain_score: int = 4
    max_chain_gap: int = 210  # MAX_ERROR * MIN_READ_SIZE (globals.cc:30)
    refine: RefineParams = dataclasses.field(default_factory=RefineParams)


@dataclasses.dataclass
class StatsParams:
    """Stage-3 reporting parameters (reference ``globals.h:90-103``)."""

    max_ok_gap: int = -1
    min_split_size: int = KB
    min_uppercase: int = 100
    max_scaled_error: float = 0.5
    min_assembly_gap_size: int = 100
    big_overlap_threshold: int = 100


@dataclasses.dataclass
class InternalFlags:
    """Feature gates (reference ``globals.h:105-109``)."""

    do_uppercase: bool = True
    do_uppercase_seeds: bool = True
    do_qgram: bool = True


@dataclasses.dataclass
class Config:
    search: SearchParams = dataclasses.field(default_factory=SearchParams)
    hash: HashParams = dataclasses.field(default_factory=HashParams)
    align: AlignParams = dataclasses.field(default_factory=AlignParams)
    extend: ExtendParams = dataclasses.field(default_factory=ExtendParams)
    chain: ChainParams = dataclasses.field(default_factory=ChainParams)
    stats: StatsParams = dataclasses.field(default_factory=StatsParams)
    internal: InternalFlags = dataclasses.field(default_factory=InternalFlags)

    def finalize(self) -> "Config":
        """Recompute derived parameters after any field change.

        Mirrors ``search_main.cc:223`` (MIN_READ_SIZE) and ``globals.cc:30``
        (MAX_CHAIN_GAP).
        """
        self.search.min_read_size = int(KB * (1 - self.search.max_error))
        self.chain.max_chain_gap = int(
            self.search.max_error * self.search.min_read_size
        )
        return self


DEFAULT = Config().finalize()
