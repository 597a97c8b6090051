#!/usr/bin/env python3
"""Beyond-HBM training demonstration: GANMF with urm_storage="csr" on a
synthetic dataset whose DENSE user-item matrix would crowd the device.

Default shape: 131,072 users x 65,536 items, ~100 interactions/user
(~13M nnz). Dense f32 URM = 32 GB, while the padded-CSR storage is O(nnz) (~a few hundred MB including row padding).
The reference framework cannot run this at all: it densifies every
minibatch on host from scipy (GANRec/GANMF.py:184) and CAAE holds the
full dense matrix in RAM (CAAE.py:199).

Prints one JSON line with the measured steady epoch time.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import scipy.sparse as sps

from _timing import epoch_time

U = int(os.environ.get("DEMO_USERS", 131072))
I = int(os.environ.get("DEMO_ITEMS", 65536))
NNZ_PER_USER = int(os.environ.get("DEMO_NNZ_PER_USER", 100))


def synthetic_urm(u, i, per_user, seed=0):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(u, dtype=np.int64), per_user)
    cols = rng.randint(0, i, size=u * per_user).astype(np.int64)
    mat = sps.csr_matrix(
        (np.ones(u * per_user, np.float32), (rows, cols)), shape=(u, i)
    )
    mat.sum_duplicates()
    mat.data[:] = 1.0
    return mat


def main():
    import jax.numpy as jnp

    from ganmf_tpu.models import CFGAN, GANMF, DisGANMF, IALSRecommender

    train = synthetic_urm(U, I, NNZ_PER_USER)
    dense_gb = U * I * 4 / 2**30
    stored_gb = (train.nnz * 8 / 2**30) * 1.5  # padded-CSR incl. row padding slack
    print(
        json.dumps(
            {
                "users": U,
                "items": I,
                "nnz": int(train.nnz),
                "dense_urm_gb": round(dense_gb, 1),
                "padded_csr_gb_approx": round(stored_gb, 2),
            }
        ),
        flush=True,
    )

    which = (sys.argv[1:] or ["ganmf", "disganmf", "cfgan", "ials"])

    if "ganmf" in which:
        t = epoch_time(
            lambda: GANMF(train, mode="user", seed=1, is_experiment=True),
            dict(num_factors=64, emb_dim=256, batch_size=64, urm_storage="csr"),
            n_epochs=3,
        )
        print(json.dumps({"bench": f"GANMF beyond-HBM csr epoch (U={U}, I={I})",
                          "s_per_epoch": round(t, 2)}), flush=True)

    if "disganmf" in which:
        t = epoch_time(
            lambda: DisGANMF(train, mode="user", seed=1, is_experiment=True),
            dict(num_factors=64, d_nodes=256, batch_size=128, urm_storage="csr"),
            n_epochs=3,
        )
        print(json.dumps({"bench": f"DisGANMF beyond-HBM csr epoch (U={U}, I={I})",
                          "s_per_epoch": round(t, 2)}), flush=True)

    if "cfgan" in which:
        t = epoch_time(
            lambda: CFGAN(train, mode="user", seed=1, is_experiment=True),
            dict(d_nodes=64, g_nodes=256, scheme="ZR", zr_ratio=0.3, zr_coefficient=0.1,
                 d_batch_size=128, g_batch_size=128, urm_storage="csr",
                 allow_worse=None, freq=None),
            n_epochs=3,
        )
        print(json.dumps({"bench": f"CFGAN beyond-HBM csr epoch (U={U}, I={I})",
                          "s_per_epoch": round(t, 2)}), flush=True)

    if "mfbpr" in which:
        from _timing import timeit

        from ganmf_tpu.models import MatrixFactorization_BPR

        mf = MatrixFactorization_BPR(train)
        mf.fit(epochs=1, num_factors=64, batch_size=256, urm_storage="csr")

        def mf_epoch():
            mf._run_epoch(0)
            return float(jnp.sum(mf._state.U))

        t = timeit(mf_epoch, n=2)
        print(json.dumps({"bench": f"MF-BPR beyond-HBM csr epoch (U={U}, I={I}, K=64)",
                          "s_per_epoch": round(t, 2)}), flush=True)

    if "ials" in which:
        from _timing import timeit

        ials = IALSRecommender(train)
        ials.fit(epochs=1, num_factors=64, alpha=5.0, urm_storage="csr")

        def ials_epoch():
            ials._run_epoch(0)
            return float(jnp.sum(ials._U_dev))

        t = timeit(ials_epoch, n=2)
        print(json.dumps({"bench": f"IALS beyond-HBM csr epoch (U={U}, I={I}, K=64)",
                          "s_per_epoch": round(t, 2)}), flush=True)


if __name__ == "__main__":
    main()
