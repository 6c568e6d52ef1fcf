"""Run chip_smoke.py on the kernels of an earlier commit, for a "before"
column measured by the same script as the change.

Unpack the earlier commit (git archive <commit> | tar -x -C <dir>), copy
this file and the newer chip_smoke.py into <dir>, and run from there on a
machine with the card:

    python3 smoke_on_parent.py [--seed N]

The checks and plan reports of kernels the earlier commit lacks are left
out: hw_adaptive's cluster launch (its phase-2 check,
check_adaptive_cluster, its plan= on the measured calls and its NEW_FORMS
entry).  Everything else runs as chip_smoke.py does.
"""

import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

NEW_CHECKS = ("check_adaptive_cluster",)
NEW_PLANS = ("hw_adaptive",)

for name in NEW_CHECKS:
    skipped = lambda *a: None  # noqa: E731
    skipped.__name__ = name + "_skipped"
    setattr(cs, name, skipped)
for name in NEW_PLANS:
    cs.NEW_FORMS.pop(name)
cs.PLANNED = tuple(n for n in cs.PLANNED if n not in NEW_PLANS)
sys.exit(cs.main())
