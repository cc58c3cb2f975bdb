"""Leveled logging in the spirit of av_log (libavutil/log.h).

Module-level logger with ERROR/WARNING/INFO/DEBUG/TRACE levels; the CLI maps
-loglevel onto it. Kept deliberately thin — stdlib logging underneath.
"""

import logging

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

logger = logging.getLogger("ffmpeg_ht_tpu_torch")


def set_level(name: str) -> None:
    level = {
        "quiet": logging.CRITICAL,
        "error": logging.ERROR,
        "warning": logging.WARNING,
        "info": logging.INFO,
        "verbose": logging.INFO,
        "debug": logging.DEBUG,
        "trace": TRACE,
    }[name]
    logger.setLevel(level)


def trace(msg: str, *args) -> None:
    logger.log(TRACE, msg, *args)
