from .plonk import ProvingKey, VerifyingKey, keygen, prove, verify, verify_succinct
from .srs import SRS, gen_srs
from .transcript import Transcript
