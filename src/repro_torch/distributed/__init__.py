"""Replicated data parallelism's host side (port of ``repro.distributed``, in part).

Only ``rdp``'s host part is ported: the shard assignment, its coverage after
failures and the elastic controller.  The mesh code (``make_rdp_mesh``,
``sharding``, ``axes``, ``collectives``) waits for ``torch.distributed``
(``ROADMAP.md`` §1, item 2).
"""
