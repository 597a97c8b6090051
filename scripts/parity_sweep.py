#!/usr/bin/env python3
"""Full parity sweep: retrain every tuned (algorithm, mode, dataset) config
with the reference's committed best_params.pkl on its committed split, and
diff MAP@20/NDCG@20 against the published test_results.

Writes results incrementally to PARITY.json and renders PARITY.md.

Usage: python scripts/parity_sweep.py [dataset ...] (default: all three)
"""

import json
import os
import pickle
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE = os.environ.get("GANMF_REFERENCE", "/root/reference")

# (algo key, mode, similarity) -> reference directory prefix
CONFIGS = [
    ("GANMF", "user", ""),
    ("GANMF", "item", ""),
    ("DisGANMF", "user", ""),
    ("DisGANMF", "item", ""),
    ("CFGAN", "user", ""),
    ("CFGAN", "item", ""),
    ("CAAE", "", ""),
    ("ALS", "", ""),
    ("PureSVD", "", ""),
    ("SLIMBPR", "", ""),
    ("ItemKNN", "", "cosine"),
    ("ItemKNN", "", "jaccard"),
    ("ItemKNN", "", "dice"),
    ("ItemKNN", "", "tversky"),
    ("ItemKNN", "", "euclidean"),
    ("ItemKNN", "", "asymmetric"),
    ("P3Alpha", "", ""),
    ("TopPop", "", ""),
]


def parse_reference_row(path: str, cutoff: int = 20):
    with open(path) as fh:
        text = fh.read()
    m = re.search(rf"CUTOFF: {cutoff} - (.*)", text)
    row = {}
    for part in m.group(1).split(", "):
        if ": " in part:
            k, v = part.split(": ")
            try:
                row[k.strip()] = float(v)
            except ValueError:
                pass
    return row


def main(datasets):
    from ganmf_tpu.cli.experiment import DICT_REC_CLASSES
    from ganmf_tpu.cli.run_best import run as run_best

    out_json = "PARITY.json"
    results = {}
    if os.path.exists(out_json):
        results = json.load(open(out_json))

    for dataset in datasets:
        for algo, mode, sim in CONFIGS:
            rec_name = DICT_REC_CLASSES[algo].RECOMMENDER_NAME
            key = f"{rec_name}_{mode}{sim}_{dataset}"
            if key in results and "error" not in results[key]:
                continue
            ref_dir = os.path.join(REFERENCE, "test_results", key)
            if not os.path.isdir(ref_dir):
                print(f"skip {key}: no reference results")
                continue
            print(f"=== {key} ===", flush=True)
            t0 = time.time()
            try:
                ours = run_best(
                    dataset, algo, train_mode=mode, sim=sim, force=True,
                    bp_dir=os.path.join(REFERENCE, "experiments"),
                    out_root="test_results",
                )
                ref = parse_reference_row(os.path.join(ref_dir, "test_results.txt"))
                entry = {
                    "MAP@20": {"ours": float(ours[20]["MAP"]), "ref": ref.get("MAP")},
                    "NDCG@20": {"ours": float(ours[20]["NDCG"]), "ref": ref.get("NDCG")},
                    "wall_s": round(time.time() - t0, 1),
                }
                entry["MAP@20"]["delta"] = round(entry["MAP@20"]["ours"] - entry["MAP@20"]["ref"], 7)
                entry["NDCG@20"]["delta"] = round(entry["NDCG@20"]["ours"] - entry["NDCG@20"]["ref"], 7)
                results[key] = entry
                print(json.dumps(entry), flush=True)
            except Exception as err:
                results[key] = {"error": f"{type(err).__name__}: {err}", "wall_s": round(time.time() - t0, 1)}
                print("ERROR:", results[key]["error"], flush=True)
            json.dump(results, open(out_json, "w"), indent=1)

    render_md(results)


def render_md(results):
    lines = [
        "# PARITY — retrained with reference best params on reference splits",
        "",
        "MAP@20 / NDCG@20 vs the published `test_results.txt`.",
        "",
        "| Config | MAP@20 ours | MAP@20 ref | dMAP | NDCG@20 ours | NDCG@20 ref | dNDCG |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        e = results[key]
        if "error" in e:
            lines.append(f"| {key} | ERROR: {e['error']} | | | | | |")
        else:
            m, n = e["MAP@20"], e["NDCG@20"]
            lines.append(
                f"| {key} | {m['ours']:.7f} | {m['ref']:.7f} | {m['delta']:+.5f} "
                f"| {n['ours']:.7f} | {n['ref']:.7f} | {n['delta']:+.5f} |"
            )
    # the detailed notes (incl. the ItemKNN NDCG archaeology evidence) are
    # maintained by hand in PARITY_NOTES.md and appended verbatim
    lines.append("")
    if os.path.isfile("PARITY_NOTES.md"):
        lines.append(open("PARITY_NOTES.md").read().rstrip())
    with open("PARITY.md", "w") as fh:
        fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:] or ["LastFM", "hetrec2011", "1M"])
