"""Fixed TCP ports for the port's multi-process tests on the CPU: a
block of 100 a pytest-xdist worker, below Linux's ephemeral range
(32768-60999 by default, ``/proc/sys/net/ipv4/ip_local_port_range``).

The kernel hands out ephemeral ports to every outgoing connection and
every bind to port 0: the gangs' own gloo pairs, the JAX engines'
aiohttp test servers, other workers' tests. A gang's coordinator,
control channel or HTTP port picked inside that range can be taken in
the seconds between the pick and the gang's bind, and the gang then
fails to start; below the range only a test that names the port can
hold it.

Offsets within a worker's block, one a gang:
    0, 90        tests/test_torch_multihost.py
    10 .. 40     tests/test_torch_gang_serving.py
    50, 51       tests/test_torch_fsdp.py (the trainer gang, its resume)
    60           tests/test_torch_kv_int8.py
    70, 71       tests/test_torch_parallel.py (the trainer gang, its resume)
A coordinator's serving control channel is 1000 above it
(serve/multihost.py ``control_address``). Blocks stay apart for up to
ten workers.
"""
import os

COORD_BASE = 22000
HTTP_BASE = 28000


def worker_index() -> int:
    """This pytest-xdist worker's index (gw3 → 3; 0 without xdist)."""
    worker = os.environ.get('PYTEST_XDIST_WORKER', 'gw0')
    return int(worker[2:]) if worker[2:].isdigit() else 0


def coord_port(offset: int) -> int:
    """A gang's coordinator (its control channel 1000 above)."""
    return COORD_BASE + 100 * worker_index() + offset


def http_port(offset: int) -> int:
    """A serving gang's HTTP port."""
    return HTTP_BASE + 100 * worker_index() + offset
