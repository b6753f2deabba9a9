from .adamw import make_adamw
from .q8adam import make_q8adam
from .schedules import warmup_cosine
from .compression import compress_int8, decompress_int8
