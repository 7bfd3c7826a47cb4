"""The drift guard: the host-side modules the port copies from the reference
(``tidb_tpu_torch.copies.COPIES``) stay the reference's text with the import
prefix rewritten, byte for byte, except the seam modules, whose differences
stay inside the units ``SEAMS`` names (and every named unit does differ)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidb_tpu_torch import copies  # noqa: E402

PLAIN = [rel for rel in copies.COPIES if rel not in copies.SEAMS]


@pytest.mark.parametrize("rel", PLAIN)
def test_copy_equals_rewritten_reference(rel):
    assert copies.port_text(rel) == copies.reference_text(rel)


@pytest.mark.parametrize("rel", sorted(copies.SEAMS))
def test_seam_differs_only_where_declared(rel):
    assert rel in copies.COPIES
    assert copies.drift(rel) == []
    assert copies.seam_units(rel) == sorted(copies.SEAMS[rel])


def test_rewrite_touches_import_lines_only():
    src = (
        "import tidb_tpu\n"
        "from tidb_tpu.kv import kv\n"
        "    from tidb_tpu import config as c\n"
        "import tidb_tpu_helpers\n"
        '"tidb_tpu_copr_task_total"\n'
        "# see tidb_tpu.copr.client\n"
    )
    assert copies.rewrite(src) == (
        "import tidb_tpu_torch\n"
        "from tidb_tpu_torch.kv import kv\n"
        "    from tidb_tpu_torch import config as c\n"
        "import tidb_tpu_helpers\n"
        '"tidb_tpu_copr_task_total"\n'
        "# see tidb_tpu.copr.client\n"
    )


def test_units_split_methods_from_their_class():
    src = 'class A:\n    """doc"""\n\n    x = 1\n\n    def f(self):\n        return 1\n\n\ndef g():\n    pass\n'
    u = copies.units(src)
    assert set(u) == {"A", "A.f", "g"}
    assert "def f" not in u["A"] and "return 1" in u["A.f"]
