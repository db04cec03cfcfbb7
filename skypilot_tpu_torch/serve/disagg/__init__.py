"""Disaggregated prefill/decode serving (a port of skypilot_tpu/serve/
disagg): a PREFILL replica prefills a prompt and samples its first
token, then ships the request's KV rows and sampler state to a DECODE
replica, which adopts the rows into pages of its own allocator and
decodes. The engine's ``/disagg/prefill`` and ``/disagg/continue``
endpoints live in serve/engine.py; :mod:`.handoff` is the transport.
"""
