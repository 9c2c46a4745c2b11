"""Resilience: fault injection (``faults``: the launcher's ``launch.worker``
and ``launch.grow``, the membership store's ``membership.heartbeat``, the
process group's ``dist.rendezvous`` and ``collective.barrier``, the
checkpoint sites ``checkpoint.write``, ``ckpt.write`` and ``train.preempt``,
and the serving path's ``serve.admit`` and ``serve.client``) and the outage
classifiers with their retry policy (``outage``)."""
