"""Dense exon-interval transcript model.

The reference keeps transcripts as linked C structs (trans_t/read_trans_t,
reference gtf.h:39-58).  Here the whole transcript set is a struct-of-arrays
with padded exon tensors so classification/merge can run as vectorized
interval ops (and batch onto the accelerator):

    exon_start/exon_end : int32 [n, E]   (1-based inclusive, padded with 0)
    exon_n              : int32 [n]
    tid, start, end     : int32 [n]
    is_rev              : uint8 [n]
    cov                 : int32 [n]      (transcript_cov; reference trans_t.cov)
    flag bit-columns    : bool  [n]      (full/lfull/lnoth/rfull/rnoth/known/
                                          has_known_site/has_unreliable_junction/
                                          partial_read; reference gtf.h:47-50)
    novel_exon_flag     : uint8 [n, E]
    novel_site_flag     : uint8 [n, (E-1)*2]   (don at 2j, acc at 2j+1)
    novel_junction_flag : uint8 [n, E-1]
    unreliable_junction_flag : uint8 [n, E-1]

Names (gene_id/gene_name/trans_id/trans_name) stay host-side as Python lists
— they never touch the compute path.

Coordinate convention is identical to the reference: 1-based inclusive
[start, end] on the reference genome.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Splice-junction / classification defaults, mirroring reference gtf.h:118-140
# and update_gtf.h:6.
INTRON_MIN_LEN = 3
INTER_EXON_MIN_LEN = 3
DELETION_MAX_LEN = 50
SPLICE_DISTANCE = 0
END_DISTANCE = 0x7FFFFFFF
MIN_INTRON_NUM = 0
SING_OVLP_FRAC = 0.80
MIN_SJ_CNT = 1

FLAG_NAMES = (
    "full", "lfull", "lnoth", "rfull", "rnoth",
    "known", "has_known_site", "has_unreliable_junction", "partial_read",
)


@dataclass
class UpdateGtfParams:
    """Knob set of `update-gtf` (reference update_gtf.h:8-15, defaults at
    update_gtf.c:24-35)."""

    input_mode: str = "bam"        # 'bam' | 'gtf'
    use_multi: bool = False        # -M
    min_sj_cnt: int = MIN_SJ_CNT   # -J
    min_exon: int = INTER_EXON_MIN_LEN    # -e
    min_intron: int = INTRON_MIN_LEN      # -i
    max_delet: int = DELETION_MAX_LEN     # -t
    ss_dis: int = SPLICE_DISTANCE         # -d
    end_dis: int = END_DISTANCE           # -D
    full_level: int = 5                   # -l (5 = most relaxed)
    split_trans: bool = False             # -s
    single_exon_ovlp_frac: float = SING_OVLP_FRAC  # -f
    keep_min_set: bool = False            # -n
    force_strand: bool = False            # -c
    source: str = "lr2rmats_tpu"          # -S
    # Replicate the reference's acceptor-site matching off-by-one
    # (update_gtf.c:746) bit-for-bit instead of the corrected default
    # semantics.  See ARCHITECTURE.md §5 "acceptor-site matching" and
    # tests/test_reference_oracle.py.  CLI: --ref-compat; env:
    # LR2RMATS_REF_COMPAT=1 (read per-instantiation so tests can flip it).
    ref_acceptor_compat: bool = field(default_factory=lambda: __import__(
        "os").environ.get("LR2RMATS_REF_COMPAT", "0") not in ("", "0"))


DEFAULTS = UpdateGtfParams()


class Transcripts:
    """Growable struct-of-arrays transcript set (reference read_trans_t)."""

    __slots__ = (
        "exon_start", "exon_end", "exon_n", "tid", "is_rev", "start", "end",
        "cov", "flags", "novel_exon_flag", "novel_site_flag",
        "novel_junction_flag", "unreliable_junction_flag",
        "gene_id", "gene_name", "trans_id", "trans_name",
        "n", "_cap", "_ecap", "gene_n",
    )

    def __init__(self, cap: int = 16, max_exons: int = 8):
        self.n = 0
        self.gene_n = 0
        self._cap = max(cap, 1)
        self._ecap = max(max_exons, 2)
        c, e = self._cap, self._ecap
        self.exon_start = np.zeros((c, e), np.int32)
        self.exon_end = np.zeros((c, e), np.int32)
        self.exon_n = np.zeros(c, np.int32)
        self.tid = np.zeros(c, np.int32)
        self.is_rev = np.zeros(c, np.uint8)
        self.start = np.zeros(c, np.int32)
        self.end = np.zeros(c, np.int32)
        self.cov = np.ones(c, np.int32)
        self.flags = {name: np.zeros(c, bool) for name in FLAG_NAMES}
        self.novel_exon_flag = np.zeros((c, e), np.uint8)
        self.novel_site_flag = np.zeros((c, 2 * (e - 1)), np.uint8)
        self.novel_junction_flag = np.zeros((c, e - 1), np.uint8)
        self.unreliable_junction_flag = np.zeros((c, e - 1), np.uint8)
        self.gene_id: List[str] = []
        self.gene_name: List[str] = []
        self.trans_id: List[str] = []
        self.trans_name: List[str] = []

    # ------------------------------------------------------------------ util
    def copy(self) -> "Transcripts":
        """Independent deep copy of the tensor columns (string lists copy
        shallowly — strings are immutable).  Used to reuse one ingestion of
        a large input across the two update-gtf passes, both of which
        mutate flags in place."""
        T = Transcripts.__new__(Transcripts)
        T.n = self.n
        T.gene_n = self.gene_n
        T._cap = self._cap
        T._ecap = self._ecap
        for a in ("exon_start", "exon_end", "exon_n", "tid", "is_rev",
                  "start", "end", "cov", "novel_exon_flag",
                  "novel_site_flag", "novel_junction_flag",
                  "unreliable_junction_flag"):
            setattr(T, a, getattr(self, a).copy())
        T.flags = {k: v.copy() for k, v in self.flags.items()}
        T.gene_id = list(self.gene_id)
        T.gene_name = list(self.gene_name)
        T.trans_id = list(self.trans_id)
        T.trans_name = list(self.trans_name)
        return T

    @property
    def max_exons(self) -> int:
        return self._ecap

    def _grow_rows(self, need: int) -> None:
        cap = self._cap
        while cap < need:
            cap <<= 1
        pad = cap - self._cap

        def _p(a, axis=0):
            w = [(0, 0)] * a.ndim
            w[axis] = (0, pad)
            return np.pad(a, w)

        self.exon_start = _p(self.exon_start)
        self.exon_end = _p(self.exon_end)
        self.exon_n = _p(self.exon_n)
        self.tid = _p(self.tid)
        self.is_rev = _p(self.is_rev)
        self.start = _p(self.start)
        self.end = _p(self.end)
        self.cov = np.concatenate([self.cov, np.ones(pad, np.int32)])
        for k in self.flags:
            self.flags[k] = _p(self.flags[k])
        self.novel_exon_flag = _p(self.novel_exon_flag)
        self.novel_site_flag = _p(self.novel_site_flag)
        self.novel_junction_flag = _p(self.novel_junction_flag)
        self.unreliable_junction_flag = _p(self.unreliable_junction_flag)
        self._cap = cap

    def _grow_exons(self, need: int) -> None:
        ecap = self._ecap
        while ecap < need:
            ecap <<= 1
        d = ecap - self._ecap

        def _p(a, width):
            return np.pad(a, [(0, 0), (0, width)])

        self.exon_start = _p(self.exon_start, d)
        self.exon_end = _p(self.exon_end, d)
        self.novel_exon_flag = _p(self.novel_exon_flag, d)
        self.novel_site_flag = _p(self.novel_site_flag, 2 * d)
        self.novel_junction_flag = _p(self.novel_junction_flag, d)
        self.unreliable_junction_flag = _p(self.unreliable_junction_flag, d)
        self._ecap = ecap

    # ------------------------------------------------------------ appending
    def append(
        self,
        tid: int,
        is_rev: bool,
        exon_start: Sequence[int],
        exon_end: Sequence[int],
        gene_id: str = "",
        gene_name: str = "",
        trans_id: str = "",
        trans_name: str = "",
        cov: int = 1,
        init_novel: bool = True,
        flags: Optional[dict] = None,
        novel_exon_flag: Optional[np.ndarray] = None,
        novel_site_flag: Optional[np.ndarray] = None,
        novel_junction_flag: Optional[np.ndarray] = None,
        unreliable_junction_flag: Optional[np.ndarray] = None,
    ) -> int:
        """Append one transcript; exons must be coordinate-sorted ascending.

        `init_novel=True` reproduces read_bam_trans's all-novel init
        (reference bam2gtf.c:97-102): novel_exon/site/junction = 1,
        unreliable_junction = 0, lnoth/rnoth = 1.
        """
        en = len(exon_start)
        assert en == len(exon_end) and en >= 1
        if self.n + 1 > self._cap:
            self._grow_rows(self.n + 1)
        if en > self._ecap:
            self._grow_exons(en)
        i = self.n
        # rows at index >= n are untouched-zero (fresh or grown with zero
        # padding; append indices are never reused), so no re-zeroing needed
        self.exon_start[i, :en] = exon_start
        self.exon_end[i, :en] = exon_end
        self.exon_n[i] = en
        self.tid[i] = tid
        self.is_rev[i] = 1 if is_rev else 0
        self.start[i] = exon_start[0]
        self.end[i] = exon_end[en - 1]
        self.cov[i] = cov
        if init_novel:
            self.flags["lnoth"][i] = True
            self.flags["rnoth"][i] = True
            self.novel_exon_flag[i, :en] = 1
            if en > 1:
                self.novel_site_flag[i, : 2 * (en - 1)] = 1
                self.novel_junction_flag[i, : en - 1] = 1
        if flags:
            for k, v in flags.items():
                self.flags[k][i] = bool(v)
        if novel_exon_flag is not None:
            self.novel_exon_flag[i, :en] = novel_exon_flag
        if novel_site_flag is not None:
            self.novel_site_flag[i, : 2 * (en - 1)] = novel_site_flag
        if novel_junction_flag is not None:
            self.novel_junction_flag[i, : en - 1] = novel_junction_flag
        if unreliable_junction_flag is not None:
            self.unreliable_junction_flag[i, : en - 1] = unreliable_junction_flag
        self.gene_id.append(gene_id)
        self.gene_name.append(gene_name)
        self.trans_id.append(trans_id)
        self.trans_name.append(trans_name)
        self.n += 1
        return i

    def append_batch(self, tid: np.ndarray, is_rev: np.ndarray,
                     exon_start_flat: np.ndarray, exon_end_flat: np.ndarray,
                     exon_off: np.ndarray, names: List[str]) -> None:
        """Bulk append of n all-novel-initialized transcripts (the
        read_bam_trans init, bam2gtf.c:97-104) from ragged exon arrays.

        exon_off has n+1 entries; record i's exons are
        exon_*_flat[exon_off[i]:exon_off[i+1]] (coordinate-sorted).
        All four name fields get names[i] (reference bam2gtf.c:104).
        """
        n = len(tid)
        if n == 0:
            return
        en = np.diff(exon_off).astype(np.int32)
        E = int(en.max())
        if self.n + n > self._cap:
            self._grow_rows(self.n + n)
        if E > self._ecap:
            self._grow_exons(E)
        i0 = self.n
        sl = slice(i0, i0 + n)
        col = np.arange(self._ecap)
        mask = col[None, :] < en[:, None]                      # [n, ecap]
        idx = np.clip(exon_off[:-1, None] + col[None, :], 0,
                      len(exon_start_flat) - 1)
        self.exon_start[sl] = np.where(mask, exon_start_flat[idx], 0)
        self.exon_end[sl] = np.where(mask, exon_end_flat[idx], 0)
        self.exon_n[sl] = en
        self.tid[sl] = tid
        self.is_rev[sl] = is_rev
        self.start[sl] = exon_start_flat[exon_off[:-1]]
        self.end[sl] = exon_end_flat[exon_off[1:] - 1]
        self.cov[sl] = 1
        self.flags["lnoth"][sl] = True
        self.flags["rnoth"][sl] = True
        self.novel_exon_flag[sl] = mask.astype(np.uint8)
        jcol = np.arange(self._ecap - 1)
        jmask = jcol[None, :] < (en - 1)[:, None]
        self.novel_junction_flag[sl] = jmask.astype(np.uint8)
        self.novel_site_flag[sl] = np.repeat(jmask, 2, axis=1).astype(np.uint8)
        self.unreliable_junction_flag[sl] = 0
        self.gene_id.extend(names)
        self.gene_name.extend(names)
        self.trans_id.extend(names)
        self.trans_name.extend(names)
        self.n += n

    def append_many(self, other: "Transcripts", idx: np.ndarray) -> None:
        """Bulk append_from for an index array (vectorized slice copies;
        the per-row path cost ~13 us/row at 500k-transcript scale)."""
        n = len(idx)
        if n == 0:
            return
        if self.n + n > self._cap:
            self._grow_rows(self.n + n)
        E = int(other.exon_n[idx].max())
        if E > self._ecap:
            self._grow_exons(E)
        sl = slice(self.n, self.n + n)
        w = min(self._ecap, other.exon_start.shape[1])
        self.exon_start[sl, :w] = other.exon_start[idx, :w]
        self.exon_end[sl, :w] = other.exon_end[idx, :w]
        self.exon_n[sl] = other.exon_n[idx]
        self.tid[sl] = other.tid[idx]
        self.is_rev[sl] = other.is_rev[idx]
        self.start[sl] = other.start[idx]
        self.end[sl] = other.end[idx]
        self.cov[sl] = other.cov[idx]
        for k in FLAG_NAMES:
            self.flags[k][sl] = other.flags[k][idx]
        self.novel_exon_flag[sl, :w] = other.novel_exon_flag[idx, :w]
        w2 = min(self.novel_site_flag.shape[1],
                 other.novel_site_flag.shape[1])
        self.novel_site_flag[sl, :w2] = other.novel_site_flag[idx, :w2]
        wj = min(self.novel_junction_flag.shape[1],
                 other.novel_junction_flag.shape[1])
        self.novel_junction_flag[sl, :wj] = \
            other.novel_junction_flag[idx, :wj]
        self.unreliable_junction_flag[sl, :wj] = \
            other.unreliable_junction_flag[idx, :wj]
        for j in idx:
            self.gene_id.append(other.gene_id[j])
            self.gene_name.append(other.gene_name[j])
            self.trans_id.append(other.trans_id[j])
            self.trans_name.append(other.trans_name[j])
        self.n += n

    def append_from(self, other: "Transcripts", j: int) -> int:
        """Copy transcript j of `other` into self (reference add_read_trans,
        gtf.c:142-164).  Direct array-to-array fast path."""
        en = int(other.exon_n[j])
        if self.n + 1 > self._cap:
            self._grow_rows(self.n + 1)
        if en > self._ecap:
            self._grow_exons(en)
        i = self.n
        self.exon_start[i, :en] = other.exon_start[j, :en]
        self.exon_end[i, :en] = other.exon_end[j, :en]
        self.exon_n[i] = en
        self.tid[i] = other.tid[j]
        self.is_rev[i] = other.is_rev[j]
        self.start[i] = other.start[j]
        self.end[i] = other.end[j]
        self.cov[i] = other.cov[j]
        for k in FLAG_NAMES:
            self.flags[k][i] = other.flags[k][j]
        self.novel_exon_flag[i, :en] = other.novel_exon_flag[j, :en]
        ns = 2 * (en - 1)
        self.novel_site_flag[i, :ns] = other.novel_site_flag[j, :ns]
        self.novel_junction_flag[i, : en - 1] = \
            other.novel_junction_flag[j, : en - 1]
        self.unreliable_junction_flag[i, : en - 1] = \
            other.unreliable_junction_flag[j, : en - 1]
        self.gene_id.append(other.gene_id[j])
        self.gene_name.append(other.gene_name[j])
        self.trans_id.append(other.trans_id[j])
        self.trans_name.append(other.trans_name[j])
        self.n += 1
        return i

    def overwrite_from(self, i: int, other: "Transcripts", j: int) -> None:
        """Replace transcript i with other[j] in place (reference
        modify_read_trans, gtf.c:166-186)."""
        en = int(other.exon_n[j])
        if en > self._ecap:
            self._grow_exons(en)
        self.exon_start[i] = 0
        self.exon_end[i] = 0
        self.exon_start[i, :en] = other.exon_start[j, :en]
        self.exon_end[i, :en] = other.exon_end[j, :en]
        self.exon_n[i] = en
        self.tid[i] = other.tid[j]
        self.is_rev[i] = other.is_rev[j]
        self.start[i] = other.start[j]
        self.end[i] = other.end[j]
        self.cov[i] = other.cov[j]
        for k in FLAG_NAMES:
            self.flags[k][i] = other.flags[k][j]
        self.novel_exon_flag[i] = 0
        self.novel_site_flag[i] = 0
        self.novel_junction_flag[i] = 0
        self.unreliable_junction_flag[i] = 0
        self.novel_exon_flag[i, :en] = other.novel_exon_flag[j, :en]
        self.novel_site_flag[i, : 2 * (en - 1)] = other.novel_site_flag[j, : 2 * (en - 1)]
        self.novel_junction_flag[i, : en - 1] = other.novel_junction_flag[j, : en - 1]
        self.unreliable_junction_flag[i, : en - 1] = other.unreliable_junction_flag[j, : en - 1]
        self.gene_id[i] = other.gene_id[j]
        self.gene_name[i] = other.gene_name[j]
        self.trans_id[i] = other.trans_id[j]
        self.trans_name[i] = other.trans_name[j]

    # ------------------------------------------------------------- accessors
    def exons(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        en = int(self.exon_n[i])
        return self.exon_start[i, :en], self.exon_end[i, :en]

    def junctions(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(donor, acceptor) = (exon[j].end, exon[j+1].start) pairs."""
        en = int(self.exon_n[i])
        if en < 2:
            z = np.zeros(0, np.int32)
            return z, z
        return self.exon_end[i, : en - 1], self.exon_start[i, 1:en]

    def __len__(self) -> int:
        return self.n

    def sort_by_coord(self) -> np.ndarray:
        """Stable in-place sort by (tid, start, end); returns the permutation.

        The reference requires coordinate-sorted inputs ("the BAM and GTF
        files should be sorted", update_gtf.c:41) — this provides it.
        """
        order = np.lexsort((
            self.end[: self.n], self.start[: self.n], self.tid[: self.n]))
        self.permute(order)
        return order

    def permute(self, order: np.ndarray) -> None:
        n = self.n
        full = np.arange(self._cap)
        full[:n] = order
        self.exon_start = self.exon_start[full]
        self.exon_end = self.exon_end[full]
        self.exon_n = self.exon_n[full]
        self.tid = self.tid[full]
        self.is_rev = self.is_rev[full]
        self.start = self.start[full]
        self.end = self.end[full]
        self.cov = self.cov[full]
        for k in FLAG_NAMES:
            self.flags[k] = self.flags[k][full]
        self.novel_exon_flag = self.novel_exon_flag[full]
        self.novel_site_flag = self.novel_site_flag[full]
        self.novel_junction_flag = self.novel_junction_flag[full]
        self.unreliable_junction_flag = self.unreliable_junction_flag[full]
        self.gene_id = [self.gene_id[i] for i in order]
        self.gene_name = [self.gene_name[i] for i in order]
        self.trans_id = [self.trans_id[i] for i in order]
        self.trans_name = [self.trans_name[i] for i in order]
