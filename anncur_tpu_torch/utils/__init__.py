from anncur_tpu_torch.utils.tracker import TRACER, ExperimentTracker, trace_profile  # noqa: F401
