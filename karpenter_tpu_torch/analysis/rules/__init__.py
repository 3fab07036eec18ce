"""ktlint rule modules.  Each module exposes ``ID``, ``TITLE``, ``HINT`` and
``check(files) -> list[Finding]``; whole-program rules additionally set
``WHOLE_PROGRAM = True`` and accept ``check(files, project=None)`` — the
driver builds one :class:`~karpenter_tpu_torch.analysis.callgraph.Project` per
run and shares it.  The catalog lives in docs/ANALYSIS.md."""

from . import (kt001, kt002, kt003, kt004, kt005, kt006, kt007, kt008, kt009,
               kt010, kt011, kt012, kt013, kt014, kt015, kt016, kt017,
               kt018, kt019, kt020, kt021, kt022, kt023, kt024, kt025)

ALL_RULES = (kt001, kt002, kt003, kt004, kt005, kt006, kt007, kt008, kt009,
             kt010, kt011, kt012, kt013, kt014, kt015, kt016, kt017, kt018,
             kt019, kt020, kt021, kt022, kt023, kt024, kt025)

__all__ = ["ALL_RULES", "kt001", "kt002", "kt003", "kt004", "kt005", "kt006",
           "kt007", "kt008", "kt009", "kt010", "kt011", "kt012", "kt013",
           "kt014", "kt015", "kt016", "kt017", "kt018", "kt019", "kt020",
           "kt021", "kt022", "kt023", "kt024", "kt025"]
