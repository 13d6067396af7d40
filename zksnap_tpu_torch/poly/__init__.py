from .domain import Domain, domain
from .ntt import NTT, ntt
