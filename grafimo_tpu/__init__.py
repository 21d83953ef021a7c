"""grafimo_tpu — a variation-graph motif scanning framework in JAX.

A from-scratch rebuild of the capabilities of GRAFIMO (pinellolab/GRAFIMO,
reference layout surveyed in SURVEY.md) designed for an accelerator:

* graph ingestion produces in-memory packed arrays once (no subprocess/file bus,
  cf. reference ``extract_regions.py:119-237`` tmp-dir design);
* window extraction is a path-window tensorizer emitting integer code tensors
  plus metadata (position, haplotype frequency, ref flag);
* PWM scoring runs as a batched one-hot x PWM contraction on the device
  (reference hot loop: ``score_sequences.py:331-398`` numba kernel);
* the Staden (1994) score-distribution DP, p-value assignment and
  Benjamini-Hochberg q-values are computed from exact integer score
  histograms (reference: ``motif_processing.pyx:552-632``,
  ``score_sequences.py:401-430``);
* multi-device scaling shards window batches over a ``jax.sharding.Mesh`` and
  merges histograms/counters with collectives (reference parallelism was
  single-host ``multiprocessing``, ``score_sequences.py:115-157``).
"""

__version__ = "0.1.0"

from grafimo_tpu.models.motif import Motif, MotifSet  # noqa: F401
