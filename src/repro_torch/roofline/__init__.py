"""Analytic cost model of the port's steps and the NVIDIA H100's peaks
(the counterpart of ``repro/roofline/cost_model.py``)."""
