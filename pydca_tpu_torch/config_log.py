"""Logging configuration with ANSI-colored level names.

Mirror of the reference's ``pydca/config_dca/config_log.py``: a dictConfig
enabled only with ``--verbose`` on the CLIs, plus color helpers.
"""

import logging
import logging.config

LOGGING_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {
        "verbose": {
            "format": "%(levelname)s %(asctime)s %(module)s %(funcName)s %(message)s"
        },
        "simple": {"format": "%(levelname)s %(message)s"},
    },
    "handlers": {
        "console": {
            "level": "INFO",
            "class": "logging.StreamHandler",
            "formatter": "verbose",
        },
    },
    "loggers": {
        # Scope DEBUG to this package; a root-level DEBUG would also surface
        # other libraries' internal logs on every CLI --verbose run.
        "pydca_tpu_torch": {"handlers": ["console"], "level": "DEBUG", "propagate": False},
        "": {"handlers": ["console"], "level": "WARNING", "propagate": True},
    },
}


class ConsoleColor:
    """ANSI colors for log level names (``config_log.py:37-52``)."""

    nocolor = "\033[0m"
    red = "\033[31m"
    green = "\033[32m"
    yellow = "\033[33m"
    blue = "\033[34m"


def configure_logging():
    """Install the dict config and colorize WARNING/ERROR level names."""
    logging.config.dictConfig(LOGGING_CONFIG)
    logging.addLevelName(
        logging.WARNING,
        f"{ConsoleColor.yellow}{logging.getLevelName(logging.WARNING)}"
        f"{ConsoleColor.nocolor}",
    )
    logging.addLevelName(
        logging.ERROR,
        f"{ConsoleColor.red}{logging.getLevelName(logging.ERROR)}"
        f"{ConsoleColor.nocolor}",
    )
