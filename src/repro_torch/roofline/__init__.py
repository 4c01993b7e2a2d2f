"""Roofline analysis of the dry run (port of ``repro.roofline``): the
target card's constants (:mod:`.hw`), the roofline terms (:mod:`.analysis`)
and the per-device counter of a step run on fake tensors (:mod:`.counter`)."""
