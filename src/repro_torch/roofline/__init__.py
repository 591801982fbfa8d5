"""Roofline terms of the port's programs, counted per rank by a dispatch
mode (:mod:`.counter`) and set against a card's peaks (:mod:`.analysis`)."""
