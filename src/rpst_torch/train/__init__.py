"""Training of the port; counterpart of ``rpst.train`` for one device:
the step and optimizer (``step``), the non-finite guard and the signal
checkpoint (``fault``), checkpoints (``checkpoint``) and the metric log and
step timer (``metrics``)."""
