"""Tensor-parallel serving on a (data, model) mesh: the logical-axis rules
(``partition``) and the explicit collectives between ranks (``collectives``)."""
