#!/usr/bin/env python3
"""Similarity build at I >= 64k on ONE chip (VERDICT r3 #4 scale probe).

At I = 65,536 the f32 [I, I] Gram is 17 GB, past the Gram budget
(ops/similarity._GRAM_BYTE_LIMIT), so compute_similarity routes through the column-blocked streamed
build (ops/similarity._similarity_topk_colblock): the Gram materializes in
[I, width] slabs, every slab runs the same compiled program, and only the
[width, k] rankings come back. Binary data additionally rides the one-pass
bf16 Gram (bitwise-exact receipt: scripts/bf16_gram_receipt.py).

Prints build wall time for cosine at the beyond-HBM demo shape
(131,072 x 65,536, ~13M nnz) and records a PERF row.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

U = int(os.environ.get("DEMO_USERS", 131072))
I = int(os.environ.get("DEMO_ITEMS", 65536))


def main():
    from beyond_hbm_demo import synthetic_urm
    from ganmf_tpu.ops import similarity as simmod

    train = synthetic_urm(U, I, int(os.environ.get("DEMO_NNZ_PER_USER", 100)))
    assert 4 * I * I > simmod._GRAM_BYTE_LIMIT, "must take the column-blocked path"
    print(json.dumps({"users": U, "items": I, "nnz": int(train.nnz),
                      "gram_f32_gb": round(4 * I * I / 2**30, 1)}), flush=True)

    t0 = time.time()
    W = simmod.compute_similarity(train, similarity="cosine", topK=100)
    wall = time.time() - t0
    print(json.dumps({"bench": f"ItemKNN cosine build beyond-G-HBM (U={U}, I={I}, topK=100)",
                      "s": round(wall, 1), "w_nnz": int(W.nnz)}), flush=True)

    import perf_report

    perf_report.record(
        perf_report.load_rows(),
        f"ItemKNN[{U//1024}k x {I//1024}k] cosine build (int8 A-resident col-blocked)", wall,
        "f32 [I,I] Gram = 17 GB; dense int8 A (8.6 GB) read per slab by an int8 matmul "
        "(int8xint8->int32, exact); scripts/simbuild_65k.py")


if __name__ == "__main__":
    main()
