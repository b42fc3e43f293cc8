import sys

from avcbench.run import main

sys.exit(main())
