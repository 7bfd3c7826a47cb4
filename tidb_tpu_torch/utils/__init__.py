"""Host-side utilities: columnar batches, codecs, memory tracking, misc."""

_SYSVAR_ON = ("on", "true", "yes", "1")
_SYSVAR_OFF = ("off", "false", "no", "0")


def sysvar_int(vars: dict, knob: str, default: int) -> int:
    """Coerce a session sysvar to int, MySQL-style: SET stores raw strings,
    users write ON/OFF as freely as numbers, and a bad value must never
    crash planning — fall back to the default (ref: variable/sysvar.go
    TypeBool/TypeInt validation, which normalizes before the optimizer
    ever sees the value)."""
    v = vars.get(knob, default)
    if isinstance(v, str):
        s = v.strip().lower()
        if s in _SYSVAR_ON:
            return 1
        if s in _SYSVAR_OFF:
            return 0
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return int(float(v))
        except (TypeError, ValueError, OverflowError):  # '1e400' → inf
            return default
