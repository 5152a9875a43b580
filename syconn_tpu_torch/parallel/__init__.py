from .executor import (
    batchjob_enabled,
    batchjob_script,
    map_parallel,
    register_step,
    start_multiprocess,
    start_multiprocess_imap,
    start_multiprocess_obj,
)

__all__ = [
    "batchjob_enabled",
    "batchjob_script",
    "map_parallel",
    "register_step",
    "start_multiprocess",
    "start_multiprocess_imap",
    "start_multiprocess_obj",
]
