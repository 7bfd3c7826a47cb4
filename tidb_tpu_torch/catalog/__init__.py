"""Catalog: schema objects persisted in KV + cached infoschema.

Reference parity: pkg/meta (KV-encoded catalog under the ``m`` prefix),
pkg/infoschema (versioned snapshot cache), pkg/ddl (schema change — here
executed synchronously with a table rewrite for layout-changing ALTERs; the
online F1-style state machine is a later-round item, divergence documented in
catalog.catalog.Catalog.alter_table).
"""

from tidb_tpu_torch.catalog.schema import ColumnInfo, IndexInfo, TableInfo, DBInfo
from tidb_tpu_torch.catalog.catalog import Catalog, CatalogError

__all__ = ["Catalog", "CatalogError", "ColumnInfo", "IndexInfo", "TableInfo", "DBInfo"]
