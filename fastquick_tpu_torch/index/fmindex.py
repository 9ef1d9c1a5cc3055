"""FM-index construction (host, NumPy) with a TPU-friendly layout.

Functional equivalent of the reference's BWT stack (libbwa/bwt.c,
libbwa/is.c SA-IS, libbwa/bwt_gen.c, src/BwtIndexer.cpp Pac2Bwt /
bwt_bwtupdate_core / bwt_cal_sa) re-designed for TPU consumption:

- Suffix array by numpy prefix-doubling (the reduced reference is ~6.5 Mbp,
  so O(n log^2 n) with vectorized lexsort is seconds of one-time work).
- BWT stored two ways: unpacked int8 (host/tests) and 2-bit packed uint32
  words, 16 bases per word, base j of word w at bits 2*(15 - j) -- matching
  big-endian-in-word order so a lexicographic word compare matches base
  order.
- Occ checkpoints every OCC_BLOCK bases as an (n_blocks+1, 4) int32 array
  (separate from the BWT words, unlike BWA's 0x80-interleave -- XLA gathers
  the two arrays independently so interleaving buys nothing on TPU).
- The FULL suffix array kept as int32: at 6.5 Mbp that is ~26 MB, trivial
  for HBM, and turns the reference's bwt_sa inverse-Psi walk
  (libbwa/bwt.c:69, a data-dependent loop) into a single gather.

Conventions (differ from BWA internals; only results must match):
- T: text of length n over {0,1,2,3}.  SA is over T$ (n+1 rows), sentinel
  smallest.  SA[0] = n always.
- primary: the row r with SA[r] == 0 (where BWT has the sentinel).
- bwt: length-n int8 array = BWT of T$ with the sentinel row removed
  (same as BWA's stored BWT).
- occ(c, k): #occurrences of c in the sentinel-removed bwt[0:k'] where
  k' = k - (k > primary), for row bound k in [0, n+1].
- Backward search uses half-open row intervals [lo, hi); extending with
  char c: lo' = C[c] + occ(c, lo), hi' = C[c] + occ(c, hi), where
  C[c] = 1 + #{chars in T < c}.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OCC_BLOCK = 128  # bases per Occ checkpoint
BASES_PER_WORD = 16  # 2-bit bases per uint32 word


def suffix_array(t: np.ndarray) -> np.ndarray:
    """SA over T$ (n+1 entries, SA[0] = n) by prefix doubling.

    ``t`` is int array with values 0..3.  Treats out-of-range rank as -1
    (sentinel smaller than everything), which yields exactly the SA of T$.
    """
    t = np.asarray(t, dtype=np.int64)
    n = len(t)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    # Manber-Myers doubling with the derived-order trick: an array
    # sorted by the suffix rank at offset +k is obtained from the
    # previous (rank-sorted) order in O(n) (suffixes starting in the
    # last k positions first, then prior order shifted), so each round
    # needs only ONE stable integer argsort by the primary rank instead
    # of a two-key lexsort.  torch's multithreaded stable sort (CPU)
    # is ~3x numpy's here (numpy fallback kept); ranks ride int32 and
    # the doubling starts at k=8 from base-5 8-mer values (digit 0 =
    # past-the-end, so shorter suffixes sort first, exactly the -1
    # sentinel semantics).
    try:
        import torch

        def _stable_argsort(v):
            return torch.argsort(torch.from_numpy(v), stable=True).numpy()
    except Exception:  # pragma: no cover
        def _stable_argsort(v):
            return np.argsort(v, kind="stable")

    pad = np.zeros(n + 8, dtype=np.int32)
    pad[:n] = t + 1
    val = pad[:n].copy()
    for j in range(1, 8):
        val *= 5
        val += pad[j:j + n]
    order = _stable_argsort(val).astype(np.int32)
    v_ord = val[order]
    diff = np.empty(n, dtype=np.int32)
    diff[0] = 0
    diff[1:] = v_ord[1:] != v_ord[:-1]
    rank = np.empty(n, dtype=np.int32)
    rank[order] = np.cumsum(diff, dtype=np.int32)
    k = 8
    while rank[order[-1]] != n - 1 and k < n:
        # indices sorted by secondary key rank[i+k] (-1 beyond the end)
        order2 = np.concatenate([np.arange(n - k, n, dtype=np.int32),
                                 order[order >= k] - np.int32(k)])
        order = order2[_stable_argsort(rank[order2])].astype(np.int32)
        key2 = np.full(n, -1, dtype=np.int32)
        key2[: n - k] = rank[k:]
        r_ord = rank[order]
        k2_ord = key2[order]
        diff[0] = 0
        diff[1:] = (r_ord[1:] != r_ord[:-1]) | (k2_ord[1:] != k2_ord[:-1])
        new_rank = np.empty(n, dtype=np.int32)
        new_rank[order] = np.cumsum(diff, dtype=np.int32)
        rank = new_rank
        k <<= 1
    return np.concatenate([[n], order]).astype(np.int64)


def pack_2bit_words(codes: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes into uint32 words, 16 bases/word, base j at bits
    2*(15 - j%16).  Padded with 0 (A) at the tail."""
    n = len(codes)
    n_words = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(n_words * BASES_PER_WORD, dtype=np.uint64)
    padded[:n] = codes.astype(np.uint64)
    padded = padded.reshape(n_words, BASES_PER_WORD)
    shifts = (2 * (BASES_PER_WORD - 1 - np.arange(BASES_PER_WORD))).astype(np.uint64)
    words = (padded << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    return words.astype(np.uint32)


def unpack_2bit_words(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit_words: (n,) uint8 codes from packed uint32."""
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    all_codes = ((np.asarray(words)[:, None].astype(np.uint64)
                  >> shifts[None, :].astype(np.uint64))
                 & np.uint64(3)).astype(np.uint8)
    return all_codes.reshape(-1)[:n]


@dataclass
class FMIndex:
    """One direction of the FM-index (built over T or reverse(T))."""

    n: int
    primary: int  # row with SA == 0
    C: np.ndarray  # (5,) int64: C[c] = 1 + #chars < c; C[4] = n+1
    bwt_words: np.ndarray  # packed 2-bit uint32
    occ: np.ndarray  # (n_blocks+1, 4) int32 checkpoint counts
    sa: np.ndarray  # (n+1,) int32 full suffix array
    # unpacked (n,) uint8 sentinel-removed BWT; derived lazily from
    # bwt_words -- only the host-oracle occ_at() path needs it, and the
    # production (native/device) engines never touch it
    bwt_unpacked: np.ndarray | None = None

    @property
    def bwt(self) -> np.ndarray:
        if self.bwt_unpacked is None:
            self.bwt_unpacked = unpack_2bit_words(self.bwt_words, self.n)
        return self.bwt_unpacked

    @classmethod
    def build(cls, t: np.ndarray) -> "FMIndex":
        t = np.asarray(t, dtype=np.uint8)
        assert t.max(initial=0) <= 3, "text must be N-filled (codes 0..3)"
        n = len(t)
        sa = suffix_array(t)
        # BWT of T$: row r char = T[sa[r]-1], sentinel where sa[r]==0
        primary = int(np.nonzero(sa == 0)[0][0])
        bwt_full_idx = sa - 1  # -1 marks sentinel row
        rows = np.delete(bwt_full_idx, primary)
        bwt = t[rows].astype(np.uint8)
        counts = np.bincount(t, minlength=4)[:4]
        C = np.zeros(5, dtype=np.int64)
        C[0] = 1
        C[1:] = 1 + np.cumsum(counts)
        occ = cls._build_occ(bwt)
        return cls(n=n, primary=primary, C=C, bwt_unpacked=bwt,
                   bwt_words=pack_2bit_words(bwt), occ=occ,
                   sa=sa.astype(np.int32))

    @staticmethod
    def _build_occ(bwt: np.ndarray) -> np.ndarray:
        n = len(bwt)
        n_blocks = (n + OCC_BLOCK - 1) // OCC_BLOCK
        onehot = np.zeros((n_blocks * OCC_BLOCK, 4), dtype=np.int32)
        onehot[np.arange(n), bwt] = 1
        block_counts = onehot.reshape(n_blocks, OCC_BLOCK, 4).sum(axis=1)
        occ = np.zeros((n_blocks + 1, 4), dtype=np.int32)
        occ[1:] = np.cumsum(block_counts, axis=0)
        return occ

    # ---- host-side reference queries (oracles for the TPU ops) ----

    def occ_at(self, c: int, k: int) -> int:
        """#occurrences of c among BWT rows [0, k), k in [0, n+1]."""
        kp = k - (1 if k > self.primary else 0)
        block, rem = divmod(kp, OCC_BLOCK)
        cnt = int(self.occ[block, c])
        if rem:
            start = block * OCC_BLOCK
            cnt += int(np.count_nonzero(self.bwt[start:start + rem] == c))
        return cnt

    def extend_backward(self, lo: int, hi: int, c: int) -> tuple[int, int]:
        """One backward-search step with char c over [lo, hi)."""
        return (int(self.C[c]) + self.occ_at(c, lo),
                int(self.C[c]) + self.occ_at(c, hi))

    def match_exact(self, query: np.ndarray) -> tuple[int, int]:
        """Backward search of full query (codes 0..3); returns [lo, hi)."""
        lo, hi = 0, self.n + 1
        for c in query[::-1]:
            if c > 3:
                return 0, 0
            lo, hi = self.extend_backward(lo, hi, int(c))
            if lo >= hi:
                return 0, 0
        return lo, hi

    def device_arrays(self) -> dict:
        """Arrays to place in HBM for the TPU ops."""
        return {
            "bwt_words": self.bwt_words,
            "occ": self.occ,
            "sa": self.sa,
            "C": self.C.astype(np.int32),
            "primary": np.int32(self.primary),
            "n": np.int32(self.n),
        }
