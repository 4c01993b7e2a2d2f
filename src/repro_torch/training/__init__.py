"""Training, port of ``repro.training``: AdamW with f32 master weights
(:mod:`.optimizer`), the seeded synthetic token pipeline (:mod:`.data`),
the train step and loop with checkpoints, auto-resume, the straggler flag
and the NaN-step guard (:mod:`.train_step`), and the checkpoint files
(:mod:`.checkpoint`). The model's ``loss`` is differentiated by autograd;
on the card its RMSNorm and flash-attention kernels run in both directions.
"""
