from .paths import path_to, root, catenate, numbered_suffix
from .args import ArgSpec, parse_flags
from .errors import DextractorError, FormatError
from .numbers import print_number, number_digits
from .profiling import Reporter, trace_to
