#!/usr/bin/env python3
"""Raw-file ingestion receipt at ML-20M shape (VERDICT r4 #9).

The reference's primary data path parses the actual raw ratings files
(/root/reference/datasets/DataReader.py:275-379) before reindex/k-core/
split (:482-633). This exercises the repo's same pipeline end to end at
realistic shape — 20.0M raw rows, 475 MB — and times every stage:

  1. csv:  parse datasets/all_datasets/ml-20m/ratings.csv through
           read_interactions (native OpenMP parser + vectorized dedup).
  2. dat:  rewrite the dump in ratings.dat format ("::" delimiter, no
           header — the ML-1M/10M layout, datasets/Movielens.py specs),
           reparse with delimiter="::", and assert the (user, item,
           rating) arrays are identical to the csv parse.
  3. build: move the npz split cache aside and run the CLI's
           --build-dataset path (cli/experiment.py load_urms: parse ->
           dedup -> reindex -> k-core -> three-pass multinomial split ->
           cache write), then assert the rebuilt five splits are
           IDENTICAL (indptr/indices/data) to the committed artifacts
           the whole 20M scale proof ran on. Restores the cache from the
           backup if anything mismatches.

Host-only work: runs on the CPU backend (JAX_PLATFORMS=cpu) so it can
share the machine with chip jobs. PERF rows are keyed "Ingest[20M] ...".
"""

import os
import shutil
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

RAW_CSV = os.path.join(ROOT, "datasets", "all_datasets", "ml-20m", "ratings.csv")
SPLIT_DIR = os.path.join(ROOT, "experiments", "datasets")
BACKUP_DIR = os.path.join(ROOT, "experiments", "datasets_backup_ingest")


def _record_perf(name, seconds, note=""):
    import perf_report

    perf_report.record(perf_report.load_rows(), name, seconds, note)


def stage_parse():
    from ganmf_tpu.data.reader import read_interactions

    use_cols = {"user_id": 0, "item_id": 1, "rating": 2}
    t0 = time.time()
    csv_arrays = read_interactions(RAW_CSV, use_cols=use_cols, delimiter=",", header=True)
    csv_s = time.time() - t0
    n = len(csv_arrays[0])
    print(f"csv parse: {n:,} rows in {csv_s:.2f}s", flush=True)
    _record_perf("Ingest[20M] parse ratings.csv (native, 20.0M rows)", csv_s,
                 f"{n/csv_s/1e6:.1f}M rows/s incl. dedup")

    # ratings.dat layout: same rows, "::" separators, no header
    dat_path = os.path.join(ROOT, "datasets", "all_datasets", "ml-20m", "ratings.dat.tmp")
    t0 = time.time()
    with open(RAW_CSV, "rb") as src, open(dat_path, "wb") as dst:
        src.readline()  # drop the header
        while True:
            block = src.read(1 << 24)
            if not block:
                break
            dst.write(block.replace(b",", b"::"))
    rewrite_s = time.time() - t0
    try:
        t0 = time.time()
        dat_arrays = read_interactions(dat_path, use_cols=use_cols, delimiter="::", header=False)
        dat_s = time.time() - t0
        for a, b in zip(csv_arrays, dat_arrays):
            np.testing.assert_array_equal(a, b)
        print(f"dat parse: identical arrays in {dat_s:.2f}s (rewrite {rewrite_s:.1f}s)", flush=True)
        _record_perf("Ingest[20M] parse ratings.dat ('::', native)", dat_s,
                     "arrays identical to the csv parse")
    finally:
        os.remove(dat_path)


def stage_build():
    suffixes = ["_URM_train.npz", "_URM_test.npz", "_URM_validation.npz",
                "_URM_train_small.npz", "_URM_early_stop.npz"]
    files = ["20M" + s for s in suffixes]
    os.makedirs(BACKUP_DIR, exist_ok=True)
    for f in files:
        shutil.move(os.path.join(SPLIT_DIR, f), os.path.join(BACKUP_DIR, f))
    ok = False
    try:
        # the CLI path proper, as its own process (what a user runs):
        # python -m ganmf_tpu.cli.experiment --build-dataset 20M
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.time()
        subprocess.run(
            [sys.executable, "-m", "ganmf_tpu.cli.experiment", "--build-dataset", "20M"],
            check=True, env=env, cwd=ROOT, timeout=3600,
        )
        build_s = time.time() - t0

        import scipy.sparse as sps
        for f in files:
            new = sps.load_npz(os.path.join(SPLIT_DIR, f)).tocsr()
            old = sps.load_npz(os.path.join(BACKUP_DIR, f)).tocsr()
            assert new.shape == old.shape, f
            np.testing.assert_array_equal(new.indptr, old.indptr, err_msg=f)
            np.testing.assert_array_equal(new.indices, old.indices, err_msg=f)
            np.testing.assert_array_equal(new.data, old.data, err_msg=f)
        ok = True
        print(f"build: five splits rebuilt IDENTICAL in {build_s:.1f}s", flush=True)
        _record_perf("Ingest[20M] raw -> five splits (--build-dataset CLI)", build_s,
                     "rebuilt npz identical to committed artifacts")
    finally:
        if ok:
            shutil.rmtree(BACKUP_DIR)
        else:  # restore the known-good artifacts
            for f in files:
                src = os.path.join(BACKUP_DIR, f)
                if os.path.isfile(src):
                    shutil.move(src, os.path.join(SPLIT_DIR, f))
            if os.path.isdir(BACKUP_DIR) and not os.listdir(BACKUP_DIR):
                shutil.rmtree(BACKUP_DIR)


if __name__ == "__main__":
    stages = sys.argv[1:] or ["parse", "build"]
    if "parse" in stages:
        stage_parse()
    if "build" in stages:
        stage_build()
