"""Stage-2 alignment: anchors -> chains -> guided alignment -> refinement.

Equivalent of ``fast_align`` (``src/chain.cc:203-268``) and
``refine_chains`` (``src/refine.cc:23-193``).  The inter-anchor gap DPs run
through the batched wavefront aligner.
"""

from __future__ import annotations

import os

from ..config import DEFAULT, Config
from ..io.bed import Hit, SeqRef
from ..ops.anchors import generate_anchors
from ..ops.chain import chain_anchors
from ..ops.cigar import Alignment, AlnStats
from ..ops.wavefront import WavefrontAligner


def _native_region_gate(query: str, ref: str) -> bool:
    """Route this region through the native full-region align core?

    The native path wins whenever the region's gap DPs would run on the
    host anyway (no accelerator, or a dispatch latency too high for bulk
    device batching — DEVICE_BATCH_MIN is the devcal-scaled knob,
    devcal.py).  With a cheap-dispatch device the Python path stays so
    CoalescingAligner can bulk-batch gap DPs on the device; giant regions
    (>60 Kbp, the chunked regime) always keep the Python path.
    SEDEF_NATIVE_REGION=0/1 overrides."""
    env = os.environ.get("SEDEF_NATIVE_REGION")
    if env is not None:
        return env != "0"
    try:
        from ..native import lib as _native
    except Exception:  # pragma: no cover
        return False
    if _native is None or not _native.has("fast_align"):
        return False
    if max(len(query), len(ref)) > 60000:
        return False
    from ..device import accelerator

    if accelerator() is None:
        return True
    return WavefrontAligner.DEVICE_BATCH_MIN > 16


def refine_chains(hits: list[Hit], qseq: str, rseq: str, orig: Hit,
                  cfg: Config = DEFAULT,
                  aligner: WavefrontAligner | None = None) -> list[Hit]:
    """refine.cc:23-193 — O(n^2) chain-join DP over whole chains."""
    rp = cfg.chain.refine
    hits.sort(key=lambda h: h.sort_key())
    same_chr = (orig.query.name == orig.ref.name
                and orig.query.is_rc == orig.ref.is_rc)

    score = [int(rp.match * h.aln.matches() - rp.mismatch * h.aln.mismatches()
                 - rp.gap * h.aln.gap_bases()) for h in hits]
    n = len(hits)
    dp = [0] * n
    prev = [-1] * n
    maxes: set[tuple[int, int]] = set()
    for ai in range(n):
        c = hits[ai]
        if same_chr:
            qlo, qhi = c.query_start, c.query_end
            rlo, rhi = c.ref_start, c.ref_end
            qo = max(0, min(orig.query_start + qhi, orig.ref_start + rhi)
                     - max(orig.query_start + qlo, orig.ref_start + rlo))
            if ((rhi - rlo) - qo < rp.side_align
                    and (qhi - qlo) - qo < rp.side_align):
                continue
        dp[ai] = score[ai]
        for aj in range(ai - 1, -1, -1):
            p = hits[aj]
            cqs = max(c.query_start, p.query_end)
            crs = max(c.ref_start, p.ref_end)
            if p.query_end >= c.query_end or p.ref_end >= c.ref_end:
                continue
            if p.ref_start >= c.ref_start:
                continue
            ma = max(cqs - p.query_end, crs - p.ref_end)
            mi = min(cqs - p.query_end, crs - p.ref_end)
            if ma >= rp.max_gap:
                continue
            if same_chr:
                qo = max(0, min(orig.query_start + cqs,
                                orig.ref_start + crs)
                         - max(orig.query_start + p.query_end,
                               orig.ref_start + p.ref_end))
                if qo >= 1:
                    continue
            mis = int(rp.mismatch * mi)
            gap = int(rp.gap_open + rp.gap * (ma - mi))
            sco = dp[aj] + score[ai] - mis - gap
            if sco >= dp[ai]:
                dp[ai] = sco
                prev[ai] = aj
        maxes.add((dp[ai], ai))

    used = [False] * n
    out: list[Hit] = []
    for m_score, maxi in sorted(maxes, reverse=True):
        if m_score == 0:
            break
        if used[maxi]:
            continue
        path: list[int] = []
        while maxi != -1 and not used[maxi]:
            path.insert(0, maxi)
            used[maxi] = True
            maxi = prev[maxi]

        qlo = hits[path[0]].query_start
        qhi = hits[path[-1]].query_end
        rlo = hits[path[0]].ref_start
        rhi = hits[path[-1]].ref_end

        est_size = hits[path[0]].aln.span()
        for i in range(1, len(path)):
            est_size += hits[path[i]].aln.span()
            est_size += max(hits[path[i]].query_start
                            - hits[path[i - 1]].query_end,
                            hits[path[i]].ref_start
                            - hits[path[i - 1]].ref_end)
        if est_size < rp.min_read - rp.side_align:
            continue

        overlap = False
        for h in out:
            qo = max(0, min(qhi, h.query_end) - max(qlo, h.query_start))
            ro = max(0, min(rhi, h.ref_end) - max(rlo, h.ref_start))
            if (qhi - qlo - qo < rp.side_align
                    and rhi - rlo - ro < rp.side_align):
                overlap = True
                break
        if overlap:
            continue

        hit = Hit(hits[0].query, qlo, qhi, hits[0].ref, rlo, rhi)

        guide: list[Alignment] = []
        prev_hit = hits[path[0]]
        for pi in range(1, len(path)):
            cur = hits[path[pi]]
            if (cur.query_start < prev_hit.query_end
                    or cur.ref_start < prev_hit.ref_end):
                prev_hit.aln.merge(cur.aln, qseq, rseq, aligner)
                prev_hit.update_from_alignment()
            else:
                guide.append(prev_hit.aln)
                prev_hit = cur
        guide.append(prev_hit.aln)

        hit.aln = Alignment.from_guide(qseq, rseq, guide, rp.side_align,
                                       aligner)
        hit.update_from_alignment()
        if hit.aln.span() >= rp.min_read:
            out.append(hit)
    return out


def fast_align(query: str, ref: str, orig: Hit, kmer_size: int = 11,
               cfg: Config = DEFAULT,
               aligner: WavefrontAligner | None = None) -> list[Hit]:
    """chain.cc:203-268"""
    same_chr = (orig.query.name == orig.ref.name
                and orig.query.is_rc == orig.ref.is_rc)
    if _native_region_gate(query, ref):
        from ..native import lib as _native
        rows = _native.fast_align_region(
            query.encode("ascii"), ref.encode("ascii"), same_chr,
            orig.query_start, orig.ref_start, kmer_size, cfg)
        if rows is not None:
            out: list[Hit] = []
            for qs, qe, rs, re, m, mm, gb, cigar in rows:
                h = Hit(SeqRef("QRY", False, len(query)), qs, qe,
                        SeqRef("REF", False, len(ref)), rs, re)
                h.aln = AlnStats(cigar, m, mm, gb)
                out.append(h)
            return out
        # native core bailed (giant DP / unexpected state): Python path
    anchors = generate_anchors(query, ref, same_chr, orig.query_start,
                               orig.ref_start, kmer_size)
    path, bounds = chain_anchors(anchors, cfg)

    query_ref = SeqRef("QRY", False, len(query))
    ref_ref = SeqRef("REF", False, len(ref))

    hits: list[Hit] = []
    guides: list[list[int]] = []
    for bi in range(1, len(bounds)):
        be, has_u = bounds[bi]
        bs = bounds[bi - 1][0]
        qlo = anchors[path[be - 1]].q
        qhi = anchors[path[bs]].q + anchors[path[bs]].l
        rlo = anchors[path[be - 1]].r
        rhi = anchors[path[bs]].r + anchors[path[bs]].l
        span = max(rhi - rlo, qhi - qlo)
        if ((not has_u or span < cfg.chain.min_uppercase_match)
                and span < cfg.search.min_read_size
                * (1 - cfg.search.max_error)):
            continue
        hits.append(Hit(query_ref, qlo, qhi, ref_ref, rlo, rhi,
                        jaccard=has_u))
        guides.append([path[i] for i in range(be - 1, bs - 1, -1)])

    guide_tuples = [
        [(anchors[g].q, anchors[g].r, anchors[g].l) for g in guide]
        for guide in guides]
    alns = Alignment.from_anchors_many(query, ref, guide_tuples, aligner)
    for h, aln in zip(hits, alns):
        h.aln = aln
        h.update_from_alignment()

    return refine_chains(hits, query, ref, orig, cfg, aligner)
