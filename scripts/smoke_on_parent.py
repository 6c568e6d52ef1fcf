"""Run chip_smoke.py on the kernels of an earlier commit, for a "before"
column measured by the same script as the change.

Unpack the earlier commit (git archive <commit> | tar -x -C <dir>), copy
this file and the newer chip_smoke.py into <dir>, and run from there on a
machine with the card:

    python3 smoke_on_parent.py [--seed N]

The checks and plan reports of kernels the earlier commit lacks are left
out: shw_banded's word-parallel band and reduce_eqstream's word-parallel
lane (their phase-2 checks, check_banded_words and check_word_hits with
them, their plan= on the measured calls and their NEW_FORMS entries).
Everything else runs as chip_smoke.py does.
"""

import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

NEW_CHECKS = ("check_banded_words", "check_word_hits")
NEW_PLANS = ("shw_banded", "reduce_eqstream")

for name in NEW_CHECKS:
    skipped = lambda *a: None  # noqa: E731
    skipped.__name__ = name + "_skipped"
    setattr(cs, name, skipped)
for name in NEW_PLANS:
    cs.NEW_FORMS.pop(name)
cs.PLANNED = tuple(n for n in cs.PLANNED if n not in NEW_PLANS)
sys.exit(cs.main())
