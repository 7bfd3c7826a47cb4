"""Privilege subsystem (ref: pkg/privilege — MySQLPrivilege cache over the
mysql.* grant tables, privileges/cache.go:87)."""

from tidb_tpu_torch.privilege.privileges import (
    ALL_PRIVS,
    PrivChecker,
    bootstrap_priv_tables,
    encode_password,
    encode_password_with,
    sha2_auth_token,
    verify_sha2_password,
    native_auth_token,
    verify_native_password,
)

__all__ = [
    "ALL_PRIVS",
    "PrivChecker",
    "bootstrap_priv_tables",
    "encode_password",
    "encode_password_with",
    "sha2_auth_token",
    "verify_sha2_password",
    "native_auth_token",
    "verify_native_password",
]
