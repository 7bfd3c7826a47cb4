"""Ecosystem tools (ref: br/, dumpling/, pkg/lightning — SURVEY §2.5):
backup/restore, logical dump, bulk import. Exposed both as library calls and
through the SQL surface (BACKUP/RESTORE/IMPORT INTO, ref: executor/brie.go
and disttask/importinto)."""
