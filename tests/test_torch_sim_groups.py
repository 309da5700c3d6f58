"""The port's semester simulator on a two-group LMS (the sharded cases).

Carried (`torch_carry.py`, as `test_port_semester_sim_<case>`):
`tests/test_semester_sim.py`'s sharded cases and their `groups_run`
fixture on the port's `sim/`, `config` and `utils/`: one seeded run with
two Raft groups behind the port's `RoutedLMSServicer`, the full fault
schedule plus the group drills (a group-1 leader loss and a live course
split through the port's `ReshardCoordinator` over `ClusterGroupAccess`),
the SLOs, zero acked-write loss across the split, and the replicas'
state digests converged at settle. A file of its own so that
`--dist loadfile` runs it beside `tests/test_torch_sim.py`'s sim.
"""

import torch_threads  # noqa: F401 (caps torch's threads)
from torch_carry import carry, carried_cases

_SEMESTER = carry("test_semester_sim", modules=("config", "sim", "utils"))
globals().update({
    name: case for name, case in carried_cases(
        _SEMESTER, "port_semester_sim").items()
    if name.startswith("test_port_semester_sim_sharded_")
    or name == "groups_run"})
