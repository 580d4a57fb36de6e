"""Compile-once / run-many execution: plans (:mod:`.plan`), lowering
(:mod:`.lower`) and replay (:mod:`.run`)."""
