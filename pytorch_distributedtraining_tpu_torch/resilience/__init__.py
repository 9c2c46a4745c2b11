"""Fault injection (``faults``): the serving path's ``serve.admit`` and
``serve.client`` sites."""
