"""Static analysis of the port: machine-checked invariants.

The port's twin of `repro.analysis`. The classes of bug the reference
turned into checks have torch forms here: an integer pack that outgrows
its dtype, the INF depth sentinel laundered into float32, host syncs on
the device path (`bool(t)` once a BFS round, `.item()`, `.cpu()`), a
factory that lands on the CPU. Two layers:

  * **graph audit** (`graph_audit` + `ranges`): run the public device
    programs under a dispatch mode and count every host sync and every
    float64 tensor by source site, against a documented sync budget per
    (program, BFS engine); an interval-arithmetic range propagator over
    `make_fx` aten graphs proves the packs fit (`bfs.PACKED_KEY_MAX_N`
    and `bfs.EULER_PACK_MAX_N` are asserted equal to the derived
    bounds, and the port's int64 relaxation key clean at the largest n
    it takes).
  * **AST lint** (`lint`, runnable as `python -m repro_torch.analysis`):
    the reference's rule IDs retargeted at torch (catalog in
    `lint.RULES`); `baseline.json` suppresses the justified exceptions,
    each with its reason, so a run fails only on regressions.

The package imports torch and the standard library only.
"""
from repro_torch.analysis.graph_audit import (  # noqa: F401
    AuditReport,
    SyncRecorder,
    audit_program,
    audit_service,
    check_derived_constants,
    standard_program_audits,
)
from repro_torch.analysis.lint import (  # noqa: F401
    Finding,
    RULES,
    apply_baseline,
    load_baseline,
    run_lint,
)
from repro_torch.analysis.ranges import (  # noqa: F401
    Interval,
    RangeFinding,
    check_ranges,
    derive_packed_key_max_n,
    packed_key_interval,
)
