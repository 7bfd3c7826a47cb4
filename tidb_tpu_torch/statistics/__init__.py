"""Statistics subsystem (ref: pkg/statistics — histograms, CM-sketch,
FM-sketch, TopN, ANALYZE builders, stats cache, auto-analyze; SURVEY §2.4).

Redesigned for the columnar engine: statistics are built from full-column
numpy lanes in one vectorized pass (the reference samples row streams), and
string statistics operate on order-preserving dictionary codes so range
estimation stays numeric end-to-end.
"""

from tidb_tpu_torch.statistics.histogram import Histogram, TopN
from tidb_tpu_torch.statistics.sketch import CMSketch, FMSketch
from tidb_tpu_torch.statistics.stats import ColumnStats, IndexStats, StatsHandle, TableStats
from tidb_tpu_torch.statistics.builder import analyze_table
from tidb_tpu_torch.statistics.selectivity import estimate_selectivity

__all__ = [
    "Histogram",
    "TopN",
    "CMSketch",
    "FMSketch",
    "ColumnStats",
    "IndexStats",
    "TableStats",
    "StatsHandle",
    "analyze_table",
    "estimate_selectivity",
]
