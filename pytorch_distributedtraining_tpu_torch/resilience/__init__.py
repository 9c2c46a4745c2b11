"""Resilience: fault injection (``faults``: the checkpoint sites
``checkpoint.write``, ``ckpt.write`` and ``train.preempt``, and the serving
path's ``serve.admit`` and ``serve.client``) and the outage classifier with
its retry policy (``outage``)."""
