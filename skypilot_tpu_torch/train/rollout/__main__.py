"""CLI: ``python -m skypilot_tpu_torch.train.rollout
dispatcher|worker|learner`` (the JAX CLI's subcommands and flags, plus
``--device``).

Rollout workers are low-priority managed jobs to the control plane
(dispatcher + learner on the stable on-demand node, workers harvesting
spot capacity). All subcommands print one JSON readiness line to stdout
(role, address, identity) so a supervising task — or a chaos test — can
harvest the endpoint; dispatcher and worker then serve until
SIGTERM/SIGINT. The worker and the learner run on the card
(``--device cuda``, the default) and raise without one; ``--device
cpu`` runs them on the CPU. The worker's ``--stats-file`` keeps its
accounting (rollout/worker.py).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
from typing import List, Optional

from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import knobs


def _serve_until_signal(on_stop=None) -> None:
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    if on_stop is not None:
        on_stop()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.train.rollout',
        description='Spot-harvesting RL plane: dispatcher, rollout '
                    'workers, stable GRPO learner.')
    sub = parser.add_subparsers(dest='cmd', required=True)

    disp = sub.add_parser('dispatcher',
                          help='worker registry + prompt leases')
    disp.add_argument('--host', default='0.0.0.0')
    disp.add_argument('--port', type=int, default=8480)
    disp.add_argument('--db', default='~/.skytpu/rollout/dispatcher.db')
    disp.add_argument('--heartbeat-timeout', type=float,
                      default=knobs.get_float(
                          'SKYTPU_ROLLOUT_HEARTBEAT_TIMEOUT'))
    disp.add_argument('--lease-timeout', type=float,
                      default=knobs.get_float(
                          'SKYTPU_ROLLOUT_LEASE_TIMEOUT'))
    disp.add_argument('--max-outstanding', type=int,
                      default=knobs.get_int(
                          'SKYTPU_ROLLOUT_MAX_OUTSTANDING'))

    work = sub.add_parser('worker', help='harvestable rollout worker')
    work.add_argument('--dispatcher', required=True,
                      help='host:port of the rollout dispatcher')
    work.add_argument('--worker-id', default=None)
    work.add_argument('--heartbeat-interval', type=float, default=2.0)
    work.add_argument('--leases-per-round', type=int, default=1)
    work.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'.")
    work.add_argument('--stats-file', default=None,
                      help='JSON accounting, rewritten after every lease')

    learn = sub.add_parser('learner', help='stable GRPO learner')
    learn.add_argument('--dispatcher', required=True)
    learn.add_argument('--model', default='llama-debug')
    learn.add_argument('--reward', required=True,
                       help='count_token:ID | length | module:function')
    learn.add_argument('--snapshot-dir', required=True,
                       help='shared dir for policy snapshots (workers '
                            'restore from it)')
    learn.add_argument('--steps', type=int, default=100)
    learn.add_argument('--groups-per-step', type=int, default=2)
    learn.add_argument('--group-size', type=int, default=4)
    learn.add_argument('--prompt-len', type=int, default=16)
    learn.add_argument('--max-new-tokens', type=int, default=16)
    learn.add_argument('--temperature', type=float, default=1.0)
    learn.add_argument('--kl-coef', type=float, default=0.0)
    learn.add_argument('--lr', type=float, default=1e-4)
    learn.add_argument('--eos-id', type=int, default=None)
    learn.add_argument('--seed', type=int, default=0)
    learn.add_argument('--publish-every', type=int, default=4)
    learn.add_argument('--max-staleness', type=int, default=4)
    learn.add_argument('--snapshot-keep', type=int, default=4)
    learn.add_argument('--state-dir', default=None,
                       help='learner TrainState checkpoints '
                            '(preemption resume)')
    learn.add_argument('--traj-log', default=None,
                       help='journaled trajectory log dir (replay)')
    learn.add_argument('--device', default='cuda',
                       help="'cuda' (default) or 'cpu'.")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    failpoints.load_env()
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format='%(message)s')
    args = build_parser().parse_args(argv)

    if args.cmd == 'dispatcher':
        from skypilot_tpu_torch.train.rollout import dispatcher as disp_lib
        d = disp_lib.RolloutDispatcher(
            os.path.expanduser(args.db), host=args.host, port=args.port,
            heartbeat_timeout=args.heartbeat_timeout,
            lease_timeout=args.lease_timeout,
            max_outstanding=args.max_outstanding).start()
        print(json.dumps({'role': 'dispatcher',
                          'addr': f'{d.addr[0]}:{d.addr[1]}'}),
              flush=True)
        _serve_until_signal(d.stop)
        return 0

    from skypilot_tpu_torch.utils import framed
    if args.cmd == 'worker':
        from skypilot_tpu_torch.train.rollout import worker as worker_lib
        w = worker_lib.RolloutWorker(
            framed.parse_addr(args.dispatcher),
            worker_id=args.worker_id,
            heartbeat_interval=args.heartbeat_interval,
            leases_per_round=args.leases_per_round,
            device=args.device, stats_path=args.stats_file).start()
        print(json.dumps({'role': 'worker',
                          'worker_id': w.worker_id}), flush=True)
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: w.stop())
        try:
            w.run()
        finally:
            w.stop()
        return 0

    # learner
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train.rollout import learner as learner_lib
    from skypilot_tpu_torch.train.rollout import spec as spec_lib
    cfg = config.get_config(args.model)
    spec = spec_lib.RolloutSpec(
        model=args.model, reward=args.reward,
        snapshot_dir=os.path.expanduser(args.snapshot_dir),
        vocab_size=cfg.vocab_size, prompt_len=args.prompt_len,
        group_size=args.group_size,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, kl_coef=args.kl_coef,
        eos_id=args.eos_id, seed=args.seed)
    learner = learner_lib.RolloutLearner(
        spec, framed.parse_addr(args.dispatcher),
        total_steps=args.steps,
        groups_per_step=args.groups_per_step,
        publish_every=args.publish_every,
        max_staleness=args.max_staleness,
        learning_rate=args.lr,
        snapshot_max_to_keep=args.snapshot_keep,
        state_dir=(os.path.expanduser(args.state_dir)
                   if args.state_dir else None),
        traj_log_dir=(os.path.expanduser(args.traj_log)
                      if args.traj_log else None),
        device=args.device)
    with learner:
        print(json.dumps({'role': 'learner',
                          'spec_fp': spec.fingerprint(),
                          'start_step': learner.start_step}),
              flush=True)
        learner.run()
        print(json.dumps({'role': 'learner', 'done': True,
                          **learner.report()}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
