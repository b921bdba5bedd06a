"""Wire format: .rfq header and chunk records."""
from .header import RfqFormatError, RfqHeader
from .chunk import RfqChunk
