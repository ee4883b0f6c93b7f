from .log import logger, log
from .timing import realtime, cputime, peakrss
