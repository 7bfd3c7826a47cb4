"""SQL frontend.

Reference parity: pkg/parser — a 16,850-line yacc grammar there; here a
hand-written lexer + recursive-descent parser over the MySQL subset the rest
of the stack supports (SURVEY §7.5 explicitly scopes this down: "use a small
SQL grammar, not 16k-line yacc compatibility"). Single entry point:
``parse(sql) -> ast.Statement`` (multi-statement: ``parse_many``).
"""

from tidb_tpu_torch.parser.parser import parse, parse_count, parse_many, parse_with_params, ParseError

__all__ = ["parse", "parse_count", "parse_many", "parse_with_params", "ParseError"]
