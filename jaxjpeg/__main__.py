import sys

from jaxjpeg.cli import main

sys.exit(main())
