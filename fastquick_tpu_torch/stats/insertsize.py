"""Censored insert-size estimation (Kaplan-Meier style).

Equivalent of InsertSizeEstimator (reference src/InsertSizeEstimator.cpp):
InputInsertSizeTable (:43-143) classifies .InsertSizeTable rows into
observed (PropPair) vs censored (max-insert) records, and UpdateWeight
(:145-173) runs the alternating F/G survival estimator.  The caller runs
it twice (excluding FwdOnly, then RevOnly) and sums the two densities
(StatCollector::GetInsertSizeDist, StatCollector.cpp:1969-1996).
"""

from __future__ import annotations

INSERT_LIMIT = 4096
SAM_FSR = 16
# the C initializes every bin to this epsilon (InsertSizeEstimator.h:60
# initEp), so unobserved bins carry a tiny nonzero adjusted density
INIT_EP = 1e-6


class InsertSizeEstimator:
    def __init__(self):
        self.re_init()

    def re_init(self):
        self.mis_dist = [INIT_EP] * INSERT_LIMIT
        self.obs_dist = [INIT_EP] * INSERT_LIMIT
        self.total_pair = 0

    def input_insert_size_table(self, path: str, orientation: str) -> None:
        with open(path) as fh:
            for line in fh:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 15:
                    continue
                mx = int(cols[1])
                mx2 = int(cols[2])
                obs = int(cols[3])
                flag1 = int(cols[6])
                cigar1 = cols[8]
                flag2 = int(cols[11])
                cigar2 = cols[13]
                status = cols[14]
                if mx >= INSERT_LIMIT or mx == -1:
                    mx = INSERT_LIMIT - 1
                if mx2 >= INSERT_LIMIT or mx2 == -1:
                    mx2 = INSERT_LIMIT - 1
                if obs >= INSERT_LIMIT or obs == -1:
                    obs = INSERT_LIMIT - 1
                # C skips Abnormal/LowQual/NotPair/<orientation> up front
                # (InsertSizeEstimator.cpp:76-78) -- the NotPair branch
                # below that in the C file is dead code
                if status in ("Abnormal", "LowQual", "NotPair") or status == orientation:
                    continue
                if status == "FwdOnly":
                    self.mis_dist[mx] += 1.0
                elif status == "RevOnly":
                    self.mis_dist[mx2] += 1.0
                elif status == "PropPair":
                    self.obs_dist[obs] += 1.0
                elif status == "PartialPair":
                    s1 = "S" in cigar1
                    s2 = "S" in cigar2
                    if not s1 and s2:
                        if flag1 & SAM_FSR:
                            self.mis_dist[mx2] += 1.0
                        else:
                            self.mis_dist[mx] += 1.0
                    elif s1 and not s2:
                        if flag2 & SAM_FSR:
                            self.mis_dist[mx2] += 1.0
                        else:
                            self.mis_dist[mx] += 1.0
                    else:
                        continue
                else:
                    raise RuntimeError(f"unknown insert status {status}")
                self.total_pair += 1

    def update_weight(self) -> list[float]:
        """The alternating F/G survival estimator (reference :145-173)."""
        n = 2000
        F = [0.0] * n
        f = [0.0] * n
        G = [0.0] * n
        g = [0.0] * n
        tp = float(self.total_pair) if self.total_pair else 1.0
        for k in range(n):
            m = self.mis_dist[k]
            nn = self.obs_dist[k]
            if self.total_pair == 0:
                continue
            if k != 0:
                denom = 1 - G[k - 1]
                f[k] = (nn / denom / tp) if denom != 0 else 0.0
                F[k] = F[k - 1] + f[k]
            else:
                f[k] = nn / tp
                F[k] = f[k]
            if k != 0:
                denom = 1 - F[k]
                g[k] = (m / denom / tp) if denom != 0 else 0.0
                G[k] = G[k - 1] + g[k]
            else:
                g[k] = m / tp
                G[k] = g[k]
        return f
