"""Spot-harvesting RL plane: preemptible rollout fleet → stable learner
(port of skypilot_tpu/train/rollout/, on the card unless asked for the
CPU).

A **dispatcher** (WAL-sqlite worker registry + prompt-lease state
machine over ``utils/framed`` TCP, the JAX package's wire unchanged),
**harvestable rollout workers** (stateless processes that generate GRPO
completion groups from a learner-published policy snapshot and survive
SIGKILL at any point), and a **stable learner** (``train/grpo`` update
math fed by an at-least-once trajectory stream, a staleness-bounded
off-policy window, and a journaled trajectory log whose replay
reproduces the loss trajectory bit-equal).

Why it is robust by construction:

  * a lease's prompt is a pure function of ``(spec, lease_id)`` — any
    worker can (re)compute it, so reassignment ships one integer;
  * trajectories are stamped with the snapshot version that generated
    them — the learner drops anything older than its staleness window;
  * policy snapshots ride the chunked, digest-verified checkpoint
    format (``train/checkpoints``) — workers restore onto whatever
    device they have, which is what makes them harvestable;
  * losing ANY subset of workers degrades learner throughput but never
    stalls or corrupts it.

    python -m skypilot_tpu_torch.train.rollout dispatcher|worker|learner

Not ported: ``elastic.py`` (the fleet's backpressure signal for the
elastic controller, which the port does not have) and ``harness.py``'s
``cost_per_sample`` (it prices TPUs); both stand in ROADMAP Queue 1.
"""
from skypilot_tpu_torch.train.rollout.spec import RolloutSpec  # noqa: F401
