"""IVF ANN recall/cost tradeoff on the calibrated synthetic corpus.

The reference has no ANN layer to compare against (exact-only
src/search_engine.py), so this sweep characterizes the net-new IVF
route's accuracy price on the same §6.1-shaped corpus that the
committed 9-config quality sweep uses: for each nprobe, the planted
gold recall@10, the overlap@10 with the EXACT dense top-10 (the direct
"what did approximation change" measure), and the mean scheduled tile
fraction (the share of the corpus a batch reads).

Deterministic (seed 42 corpus, seed-0 k-means); runs on the CPU backend
so the committed CSV is reproducible anywhere — quality numbers do not
depend on the platform.

Writes results/ivf_recall_sweep_synthetic.csv.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import csv
import functools

import jax.numpy as jnp
import numpy as np

print = functools.partial(print, flush=True)

MODEL = "voyage-3-large"
K = 10
N_QUERIES = 512
BATCH = 128


def main():
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.index.ivf import attach_ivf, ivf_search
    from a_nice_rag_tpu.ops.dense import dense_top_k
    from a_nice_rag_tpu.testing import calibrated_quality_corpus

    c = calibrated_quality_corpus(n_queries=N_QUERIES)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings={MODEL: c.embeddings[MODEL]}, token_lists=c.tokens,
    )
    q = jnp.asarray(c.query_embeddings[MODEL])
    gold_rows = np.asarray(
        [idx.meta.id_to_row[g] for g in c.gold_ids], np.int32
    )
    ev, eids = dense_top_k(
        idx.dense[MODEL], q, K, mask=idx.filter_mask(None)
    )
    eids = np.asarray(eids)
    exact_recall = float(np.mean(
        [gold_rows[b] in eids[b] for b in range(N_QUERIES)]
    ))

    from a_nice_rag_tpu.index.ivf import build_tile_table

    rows = []
    for spill in (False, True):
      ivf = attach_ivf(idx, MODEL, tile_n=128, n_iters=10, seed=0,
                       spill=spill)
      print(f"corpus: {idx.n_docs} docs, IVF C={ivf.n_clusters}, "
            f"tiles={ivf.n_tiles}, spill={spill}, slots={ivf.n_real}, "
            f"backend={jax.default_backend()}")
      sweep = [1, 2, 4, 8, 16, 32, 64, ivf.n_clusters]
      for nprobe in sweep:
          hits, overlap = 0, 0.0
          for lo in range(0, N_QUERIES, BATCH):
              qb = q[lo:lo + BATCH]
              _, ids, _ = ivf_search(
                  ivf, qb, K, nprobe=nprobe
              )
              ids = np.asarray(ids)
              for b in range(ids.shape[0]):
                  hits += int(gold_rows[lo + b] in ids[b])
                  overlap += len(set(ids[b]) & set(eids[lo + b])) / K
          # Scheduled-tile fraction at the LATENCY-mode micro-batch (B=8):
          # the probe union over a large batch approaches the whole corpus
          # (the documented crossover), so the bandwidth saving must be
          # read at the batch size the IVF route serves. Tile demand needs
          # only the table, not the kernel.
          fracs = []
          for lo in range(0, N_QUERIES, 8):
              _, n_uniq = build_tile_table(
                  ivf.centroids, ivf.cluster_start, q[lo:lo + 8],
                  nprobe=min(nprobe, ivf.n_clusters),
                  max_tiles=ivf.n_tiles, tile_n=ivf.tile_n,
                  mct=ivf.max_cluster_tiles,
              )
              fracs.append(float(n_uniq) / ivf.n_tiles)
          rows.append({
              "nprobe": nprobe,
              "n_clusters": ivf.n_clusters,
              "spill": int(spill),
              "n_tiles": ivf.n_tiles,
              "recall@10_planted": round(hits / N_QUERIES, 4),
              "overlap@10_vs_exact": round(overlap / N_QUERIES, 4),
              "mean_tile_fraction_b8": round(float(np.mean(fracs)), 4),
              "mean_tiles_b8": round(float(np.mean(fracs)) * ivf.n_tiles, 1),
              "exact_recall@10_planted": round(exact_recall, 4),
          })
          print(rows[-1])

    out = os.path.join(os.path.dirname(__file__), "..", "results",
                       "ivf_recall_sweep_synthetic.csv")
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {os.path.normpath(out)}")


if __name__ == "__main__":
    main()
