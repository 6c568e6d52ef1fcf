"""Run chip_smoke.py on the kernels of an earlier commit, for a "before"
column measured by the same script as the change.

Unpack the earlier commit (git archive <commit> | tar -x -C <dir>), copy
this file and the newer chip_smoke.py into <dir>, and run from there on a
machine with the card:

    python3 smoke_on_parent.py [--seed N]

The checks and plan reports of kernels the earlier commit lacks are left
out: nw_banded's word-parallel band and the capture's word groups (their
phase-2 checks, their plan= on the measured calls and their NEW_FORMS
entries).  Everything else runs as chip_smoke.py does.
"""

import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

for name in ("check_banded_words", "check_capture_words"):
    skipped = lambda *a: None  # noqa: E731
    skipped.__name__ = name + "_skipped"
    setattr(cs, name, skipped)
for name in ("nw_banded", "capture"):
    cs.NEW_FORMS.pop(name)
cs.PLANNED = tuple(n for n in cs.PLANNED if n not in ("nw_banded", "capture"))
sys.exit(cs.main())
